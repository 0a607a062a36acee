"""Planar / 3-D geometry primitives (L0).

JAX counterparts of the geometry the reference delegates to Eigen,
tf2 and OpenCV:

- ``wrap_angle``       — reference ``ArucoSlam::normAngle`` (src/aruco_slam.cpp:412-421)
- ``rodrigues`` / ``inv_rodrigues`` — reference ``cv::Rodrigues`` call sites
  (src/aruco_slam.cpp:354,478)
- ``rot2d`` / SE(2) helpers — the closed forms used throughout the EKF
  (src/aruco_slam.cpp:45-52,119-134,210-225)
- ``rpy_to_matrix``    — reference ``tf2::Quaternion::setRPY`` used by the
  map loader (src/map_loader.cpp:97-118)

All functions are pure, dtype-polymorphic, jit/vmap-safe (no data-dependent
control flow), and batched by construction where natural.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def wrap_angle(angle: Array) -> Array:
    """Wrap angle(s) into [-pi, pi).

    Matches the reference's ``normAngle`` (src/aruco_slam.cpp:412-421), which
    applies a *single* conditional +/- 2*pi correction. For inputs within
    (-3*pi, 3*pi) — every call site in the pipeline, since operands are sums
    of at most two wrapped angles — the single correction equals full
    modular wrapping; we use the branch-free exact form.
    """
    two_pi = 2.0 * jnp.pi
    a = jnp.asarray(angle)
    a = jnp.where(a >= jnp.pi, a - two_pi, a)
    a = jnp.where(a < -jnp.pi, a + two_pi, a)
    return a


def wrap_angle_full(angle: Array) -> Array:
    """Full modular wrap into [-pi, pi) for arbitrarily large angles."""
    two_pi = 2.0 * jnp.pi
    return jnp.asarray(angle) - two_pi * jnp.floor((angle + jnp.pi) / two_pi)


def rot2d(theta: Array) -> Array:
    """2x2 rotation matrix (world <- body) for heading ``theta``.

    Batched: ``theta [...]`` -> ``[..., 2, 2]``.
    """
    c, s = jnp.cos(theta), jnp.sin(theta)
    row0 = jnp.stack([c, -s], axis=-1)
    row1 = jnp.stack([s, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


# ---------------------------------------------------------------------------
# SE(2) poses as (x, y, theta) triples
# ---------------------------------------------------------------------------


def se2_compose(a: Array, b: Array) -> Array:
    """Compose planar poses: returns a ⊕ b (b expressed in a's frame).

    ``a, b [..., 3]`` -> ``[..., 3]`` with wrapped heading.
    """
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, wrap_angle(ath + bth)],
        axis=-1,
    )


def se2_inverse(a: Array) -> Array:
    """Inverse planar pose: se2_compose(a, se2_inverse(a)) == identity."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(ath), jnp.sin(ath)
    return jnp.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), wrap_angle(-ath)], axis=-1
    )


def se2_relative(a: Array, b: Array) -> Array:
    """b expressed in a's frame: a ⊖ b = a^{-1} ⊕ b.

    This is exactly the EKF observation model ``z_hat`` of the reference
    (src/aruco_slam.cpp:127-134): rotate the world-frame delta into the robot
    frame and difference the headings.
    """
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    dth = wrap_angle(b[..., 2] - a[..., 2])
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    return jnp.stack([dx * c + dy * s, -dx * s + dy * c, dth], axis=-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def rodrigues(rvec: Array) -> Array:
    """Axis-angle rotation vector -> 3x3 rotation matrix.

    Replacement for ``cv::Rodrigues`` (src/aruco_slam.cpp:354).
    Batched over leading dims; safe at theta -> 0 via the series form.
    """
    rvec = jnp.asarray(rvec)
    theta = jnp.linalg.norm(rvec, axis=-1, keepdims=True)
    small = theta < 1e-8
    safe_theta = jnp.where(small, 1.0, theta)
    axis = rvec / safe_theta
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = jnp.zeros_like(kx)
    K = jnp.stack(
        [
            jnp.stack([zero, -kz, ky], axis=-1),
            jnp.stack([kz, zero, -kx], axis=-1),
            jnp.stack([-ky, kx, zero], axis=-1),
        ],
        axis=-2,
    )
    th = theta[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    R = eye + jnp.sin(th) * K + (1.0 - jnp.cos(th)) * (K @ K)
    # For tiny angles: R ~= I + K*theta (K here contains axis*theta/theta;
    # rebuild from the raw rvec to avoid the 0/0 axis).
    rx, ry, rz = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    Kraw = jnp.stack(
        [
            jnp.stack([zero, -rz, ry], axis=-1),
            jnp.stack([rz, zero, -rx], axis=-1),
            jnp.stack([-ry, rx, zero], axis=-1),
        ],
        axis=-2,
    )
    R_small = eye + Kraw
    return jnp.where(small[..., None], R_small, R)


def inv_rodrigues(R: Array) -> Array:
    """3x3 rotation matrix -> axis-angle rotation vector. Batched."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # Skew-symmetric part
    wx = R[..., 2, 1] - R[..., 1, 2]
    wy = R[..., 0, 2] - R[..., 2, 0]
    wz = R[..., 1, 0] - R[..., 0, 1]
    w = jnp.stack([wx, wy, wz], axis=-1)
    # theta via atan2(sin, cos): f32 arccos is catastrophically inaccurate
    # near -1 (observed 1e-2 angle error at pi - 5e-3); |w| = 2 sin(theta)
    # from off-diagonal differences is well-conditioned there.
    sin_theta = 0.5 * jnp.linalg.norm(w, axis=-1)
    theta = jnp.arctan2(sin_theta, cos_theta)
    small = theta < 1e-6
    near_pi = jnp.pi - theta < 5e-3
    # Generic: axis = w / (2 sin(theta))
    scale = jnp.where(small, 0.5, theta / jnp.where(small, 1.0, 2.0 * sin_theta))
    generic = w * scale[..., None]
    # Near pi: R ~= 2 a a^T - I, so a_i a_j = (R_ij + R_ji)/4 and
    # a_p^2 = (R_pp + 1)/2. Derive the axis from the LARGEST diagonal pivot
    # (sign conventions from a single pair of off-diagonals are inconsistent
    # when the pivot component vanishes — e.g. axis (0, b, -b)).
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    sym = 0.25 * (R + jnp.swapaxes(R, -1, -2))  # a_i a_j off-diagonal

    def axis_from_pivot(p):
        a_p = jnp.sqrt(jnp.clip((diag[..., p] + 1.0) * 0.5, 1e-12, None))
        comps = [sym[..., p, i] / a_p for i in range(3)]
        comps[p] = a_p
        return jnp.stack(comps, axis=-1)

    pivot = jnp.argmax(diag, axis=-1)
    cand = jnp.stack([axis_from_pivot(p) for p in range(3)], axis=-2)
    axis_pi = jnp.take_along_axis(cand, pivot[..., None, None], axis=-2)[
        ..., 0, :
    ]
    axis_pi = axis_pi / jnp.linalg.norm(axis_pi, axis=-1, keepdims=True)
    # Align the sign with the skew part (w = 2 sin(theta) a, sin >= 0):
    # just below pi the axis sign is NOT arbitrary — the wrong sign is a
    # rotation by -theta, off by O(pi - theta) in R.
    flip = jnp.sum(axis_pi * w, axis=-1, keepdims=True) < 0.0
    axis_pi = jnp.where(flip, -axis_pi, axis_pi)
    near_pi_vec = axis_pi * theta[..., None]
    return jnp.where(near_pi[..., None], near_pi_vec, generic)


def rpy_to_matrix(roll: Array, pitch: Array, yaw: Array) -> Array:
    """Fixed-axis RPY -> rotation matrix, R = Rz(yaw) @ Ry(pitch) @ Rx(roll).

    Same convention as tf2's ``setRPY`` used by the reference map loader
    (src/map_loader.cpp:99) and marker visualization (src/aruco_slam.cpp:272).
    """
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def homography_from_4pts(src: Array, dst: Array) -> Array:
    """Exact homography mapping 4 source points to 4 destination points.

    ``src, dst [..., 4, 2]`` -> ``[..., 3, 3]`` with H[2,2] = 1.

    Solves the standard 8x8 DLT system; batched via broadcasting so it can be
    ``vmap``-ed over markers/frames. Used by PnP init and marker decoding.
    """
    src = jnp.asarray(src)
    dst = jnp.asarray(dst)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    # Rows for u equations: [x y 1 0 0 0 -u*x -u*y] h = u
    ru = jnp.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], axis=-1)
    rv = jnp.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], axis=-1)
    A = jnp.concatenate([ru, rv], axis=-2)  # [..., 8, 8]
    b = jnp.concatenate([u, v], axis=-1)[..., None]  # [..., 8, 1]
    h = jnp.linalg.solve(A, b)[..., 0]  # [..., 8]
    ones_tail = jnp.ones_like(h[..., :1])
    return jnp.concatenate([h, ones_tail], axis=-1).reshape(*h.shape[:-1], 3, 3)


def apply_homography(H: Array, pts: Array) -> Array:
    """Apply projective transform: ``H [..., 3, 3]``, ``pts [..., N, 2]``."""
    ones = jnp.ones_like(pts[..., :1])
    ph = jnp.concatenate([pts, ones], axis=-1)  # [..., N, 3]
    out = ph @ jnp.swapaxes(H, -1, -2)
    return out[..., :2] / out[..., 2:3]
