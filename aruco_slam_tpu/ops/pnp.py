"""Planar square PnP + observation extraction (L2 front-end math).

JAX replacement for ``cv::aruco::estimatePoseSingleMarkers``
(reference src/aruco_slam.cpp:314) and the downstream observation math of
``ArucoSlam::getObservations`` (src/aruco_slam.cpp:325-374) and
``ArucoSlam::CalculateCovariance`` (src/aruco_slam.cpp:437-471).

Design: instead of per-marker iterative C++ PnP we use a closed-form
homography decomposition (Zhang) for initialization followed by a
fixed-trip-count Gauss-Newton refinement on the reprojection residual —
fully batched with ``vmap`` so a frame's markers (and a batch of frames)
solve in one fused XLA computation.

Corner order matches the reference's object points (aruco_slam.h:189):
top-left, top-right, bottom-right, bottom-left on the z=0 plane,
coordinates (∓L/2, ±L/2, 0).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from aruco_slam_tpu.ops import geometry, linalg
from aruco_slam_tpu.ops.camera import (
    CameraIntrinsics,
    pixels_to_normalized,
    project_points,
    transform_points,
)

Array = jax.Array


def marker_object_points(marker_length, dtype=jnp.float32) -> Array:
    """Canonical square corners [4, 3]: TL, TR, BR, BL (aruco_slam.h:189)."""
    h = marker_length / 2.0
    return jnp.asarray(
        [[-h, h, 0.0], [h, h, 0.0], [h, -h, 0.0], [-h, -h, 0.0]], dtype=dtype
    )


class PnPResult(NamedTuple):
    rvec: Array  # [..., 3] axis-angle, object -> camera
    tvec: Array  # [..., 3] object origin in camera frame
    rms_px: Array  # [...] mean-squared pixel reprojection error (see note)


def _homography_init(corners_norm: Array, obj_xy: Array, marker_length):
    """Pose init by homography decomposition.

    ``corners_norm [..., 4, 2]`` undistorted normalized image points,
    ``obj_xy [4, 2]`` planar object coords (square, TL/TR/BR/BL). Returns
    (R, t). The homography comes from the closed-form unit-square mapping
    (ops.linalg.homography_unit_square) composed with the affine unit->object
    map — no 8x8 LU solve (batched LU lowers to a sequential pivoting loop).
    """
    dtype = corners_norm.dtype
    Hu = linalg.homography_unit_square(corners_norm)
    # unit square -> object square: x = -h + L*u, y = h - L*v; inverse:
    # u = (x+h)/L, v = (h-y)/L
    h = marker_length / 2.0
    L = marker_length
    A_inv = jnp.asarray(
        [[1.0 / L, 0.0, h / L], [0.0, -1.0 / L, h / L], [0.0, 0.0, 1.0]], dtype
    )
    H = Hu @ A_inv
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    n1 = jnp.linalg.norm(h1, axis=-1, keepdims=True)
    n2 = jnp.linalg.norm(h2, axis=-1, keepdims=True)
    lam = 2.0 / (n1 + n2)
    r1 = h1 * lam
    r2 = h2 * lam
    t = h3 * lam
    # The marker must sit in front of the camera.
    flip = jnp.where(t[..., 2:3] < 0, -1.0, 1.0)
    r1, r2, t = r1 * flip, r2 * flip, t * flip
    # Orthonormalize onto SO(3). A symmetrized Gram-Schmidt (split the
    # in-plane correction evenly between r1 and r2, as in Zhang's method)
    # instead of an SVD polar projection: SVD lowers to a large iterative
    # program (slow to compile and to run batched) and the subsequent
    # Gauss-Newton refinement absorbs the sub-degree difference anyway.
    r1n = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
    r2o = r2 - jnp.sum(r2 * r1n, axis=-1, keepdims=True) * 0.5 * r1n
    r1o = r1n - jnp.sum(r1n * r2o, axis=-1, keepdims=True) * 0.5 * r2o / jnp.sum(
        r2o * r2o, axis=-1, keepdims=True
    )
    r1o = r1o / jnp.linalg.norm(r1o, axis=-1, keepdims=True)
    r2o = r2o - jnp.sum(r2o * r1o, axis=-1, keepdims=True) * r1o
    r2o = r2o / jnp.linalg.norm(r2o, axis=-1, keepdims=True)
    r3 = jnp.cross(r1o, r2o)
    R = jnp.stack([r1o, r2o, r3], axis=-1)
    return R, t


def _planar_flip(R, t):
    """Second solution of the two-fold planar-pose ambiguity: reflect the
    marker normal about the viewing ray (Schweighofer & Pinz) — an init in
    the other basin for the dual-start refinement."""
    v = t / jnp.linalg.norm(t)
    n = R[:, 2]
    axis_raw = jnp.cross(v, n)
    s = jnp.linalg.norm(axis_raw)
    axis = axis_raw / jnp.maximum(s, 1e-9)
    theta = jnp.arctan2(s, jnp.dot(v, n))
    R_flip = geometry.rodrigues(axis * (-2.0 * theta))
    return R_flip @ R


def _gauss_newton_refine(R0, tvec, corners_norm, obj_pts, iters: int):
    """Refine the pose on normalized-coordinate reprojection residuals.

    Rotation is parameterized incrementally — R <- R0 exp(skew(dw)) — so the
    Jacobian is the closed form J = [dproj/dpc * (-R skew(X)), dproj/dpc]
    (no jacfwd: forward-mode would duplicate the whole residual graph 6x).
    Fixed trip count; the 6x6 normal equations solve with the unrolled
    Cholesky, so a whole frame of markers fuses into one program.
    Returns (R, t, final squared residual).
    """
    eye6 = 1e-9 * jnp.eye(6, dtype=tvec.dtype)

    def residual_of(R, t):
        pc = obj_pts @ R.T + t  # [4, 3]
        proj = pc[:, :2] / pc[:, 2:3]
        return (proj - corners_norm).reshape(-1), pc

    def step(carry, _):
        # The residual/points of the current iterate ride in the carry —
        # one residual evaluation per iteration (the trust-region test's
        # candidate evaluation doubles as the next iteration's linearization
        # point), bit-identical to evaluating twice.
        R, t, r, pc = carry
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        inv_z = 1.0 / z
        # dproj/dpc per point: [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
        zero = jnp.zeros_like(x)
        dpdc = jnp.stack(
            [
                jnp.stack([inv_z, zero, -x * inv_z * inv_z], axis=-1),
                jnp.stack([zero, inv_z, -y * inv_z * inv_z], axis=-1),
            ],
            axis=-2,
        )  # [4, 2, 3]
        # dpc/d(dw) = -R skew(X) per object point
        Xx, Xy, Xz = obj_pts[:, 0], obj_pts[:, 1], obj_pts[:, 2]
        zo = jnp.zeros_like(Xx)
        skewX = jnp.stack(
            [
                jnp.stack([zo, -Xz, Xy], axis=-1),
                jnp.stack([Xz, zo, -Xx], axis=-1),
                jnp.stack([-Xy, Xx, zo], axis=-1),
            ],
            axis=-2,
        )  # [4, 3, 3]
        J_rot = dpdc @ (-(R @ skewX))  # [4, 2, 3]
        J_t = dpdc  # [4, 2, 3]
        J = jnp.concatenate([J_rot, J_t], axis=-1).reshape(-1, 6)  # [8, 6]
        JtJ = J.T @ J + eye6
        delta = linalg.solve_spd(JtJ, J.T @ r, 6)
        R_new = R @ geometry.rodrigues(delta[:3] * -1.0)
        t_new = t - delta[3:]
        r_new, pc_new = residual_of(R_new, t_new)
        # Keep the step only if it reduces the residual (cheap trust region).
        better = jnp.sum(r_new**2) < jnp.sum(r**2)
        R = jnp.where(better, R_new, R)
        t = jnp.where(better, t_new, t)
        r = jnp.where(better, r_new, r)
        pc = jnp.where(better, pc_new, pc)
        return (R, t, r, pc), None

    r0, pc0 = residual_of(R0, tvec)
    (R, t, final_r, _), _ = jax.lax.scan(
        step, (R0, tvec, r0, pc0), None, length=iters
    )
    return R, t, jnp.sum(final_r**2)


def solve_pnp_square(
    corners_px: Array,
    camera: CameraIntrinsics,
    marker_length,
    refine_iters: int = 10,
) -> PnPResult:
    """Estimate marker pose from its 4 pixel corners.

    ``corners_px [4, 2]`` (single marker — ``vmap`` over a frame's markers).
    Replaces ``cv::aruco::estimatePoseSingleMarkers`` for one marker.
    """
    dtype = corners_px.dtype
    obj_pts = marker_object_points(marker_length, dtype=dtype)
    corners_norm = pixels_to_normalized(corners_px, camera)
    R0, t0 = _homography_init(corners_norm, obj_pts[:, :2], marker_length)
    # Dual-start refinement: the planar pose is two-fold ambiguous at
    # shallow view angles (measured ~2% wrong-basin convergence from a
    # single start) — like OpenCV's IPPE_SQUARE, evaluate both candidate
    # rotations and keep the lower-residual basin. Cost control: both
    # starts get a short settle — 2 iterations separates the basins'
    # residuals as reliably as 5 (flip rate 1/400 shallow-angle trials for
    # settle >= 2, equal to cv2 IPPE_SQUARE on identical trials; 2/400 at
    # settle 1) — then only the winner runs the remaining iterations.
    settle = min(2, refine_iters)
    Ra, ta, ra = _gauss_newton_refine(
        R0, t0, corners_norm, obj_pts, iters=settle
    )
    Rb, tb, rb = _gauss_newton_refine(
        _planar_flip(R0, t0), t0, corners_norm, obj_pts, iters=settle
    )
    pick_b = rb < ra
    R1 = jnp.where(pick_b, Rb, Ra)
    t1 = jnp.where(pick_b, tb, ta)
    R, tvec, _ = _gauss_newton_refine(
        R1, t1, corners_norm, obj_pts, iters=max(refine_iters - settle, 1)
    )
    rvec = geometry.inv_rodrigues(R)
    # Mean-squared pixel reprojection error, matching the reference's
    # "rmserror" (which is in fact the MSE — totalError/N with squared
    # norms summed, src/aruco_slam.cpp:460-465). Preserved semantics.
    R = geometry.rodrigues(rvec)
    proj = project_points(transform_points(R, tvec, obj_pts), camera)
    rms = jnp.mean(jnp.sum((proj - corners_px) ** 2, axis=-1))
    return PnPResult(rvec=rvec, tvec=tvec, rms_px=rms)


solve_pnp_square_batch = jax.vmap(solve_pnp_square, in_axes=(0, None, None, None))


def observation_covariance(
    rms_px: Array,
    tvec: Array,
    corners_px: Array,
    marker_length,
    r_x,
    r_y,
    r_theta,
) -> Array:
    """Empirical 3x3 observation covariance.

    Faithful port of the heuristic in ``ArucoSlam::CalculateCovariance``
    (src/aruco_slam.cpp:437-471): scale the mean-squared pixel error by the
    marker's projected diagonal and its metric distance, then apply the
    per-axis coefficients with additive floors.
    """
    diag = jnp.linalg.norm(corners_px[..., 0, :] - corners_px[..., 2, :], axis=-1)
    object_error = (rms_px / diag) * (
        jnp.linalg.norm(tvec, axis=-1) / marker_length
    )
    d = jnp.stack(
        [
            object_error * r_x + 1e-2,
            object_error * r_y + 1e-2,
            object_error * r_theta + 1e-3,
        ],
        axis=-1,
    )
    return d[..., :, None] * jnp.eye(3, dtype=d.dtype)


def camera_observation_to_robot(
    rvec: Array, tvec: Array, t_r2c_xy: Array
) -> Array:
    """Map a marker pose in the camera optical frame to the planar robot-frame
    observation ``(x, y, theta)``.

    Faithful to the reference's hard-coded optical->base axis convention
    (src/aruco_slam.cpp:359-362): x = tvec_z + t_x, y = -tvec_x + t_y,
    theta = atan2(-R02, R22); the rotation of the robot->camera extrinsic is
    intentionally ignored (translation only), as in the reference.
    """
    R = geometry.rodrigues(rvec)
    x = tvec[..., 2] + t_r2c_xy[..., 0]
    y = -tvec[..., 0] + t_r2c_xy[..., 1]
    theta = geometry.wrap_angle(jnp.arctan2(-R[..., 0, 2], R[..., 2, 2]))
    return jnp.stack([x, y, theta], axis=-1)
