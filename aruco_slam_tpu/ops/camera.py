"""Pinhole camera model with Brown-Conrady distortion (L0).

JAX replacement for the OpenCV calib3d entry points the reference
uses: ``cv::projectPoints`` (src/aruco_slam.cpp:441, reprojection-error
covariance) and the implicit undistortion inside
``cv::aruco::estimatePoseSingleMarkers`` (src/aruco_slam.cpp:314).

The camera is a pytree (``CameraIntrinsics``) so it can be closed over or
passed through ``jit``/``vmap`` freely. Distortion follows OpenCV's 5-term
model (k1, k2, p1, p2, k3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics + distortion, mirrors sensor_msgs/CameraInfo parsing
    at reference src/aruco_slam_node.cpp:121-130 (K from msg.K, dist from msg.D).
    """

    fx: Array
    fy: Array
    cx: Array
    cy: Array
    dist: Array  # [5] = (k1, k2, p1, p2, k3)

    @classmethod
    def create(cls, fx, fy, cx, cy, dist=None, dtype=jnp.float32):
        if dist is None:
            dist = jnp.zeros((5,), dtype=dtype)
        return cls(
            fx=jnp.asarray(fx, dtype),
            fy=jnp.asarray(fy, dtype),
            cx=jnp.asarray(cx, dtype),
            cy=jnp.asarray(cy, dtype),
            dist=jnp.asarray(dist, dtype),
        )

    @classmethod
    def from_camera_info(cls, K, D=None, dtype=jnp.float32):
        """Build intrinsics from sensor_msgs/CameraInfo-style fields: ``K``
        is the row-major 3x3 (9 floats) and ``D`` the distortion list —
        the exact parsing the reference node does (src/aruco_slam_node.cpp:
        121-130: K from msg.K, D from msg.D, padded/truncated to 5)."""
        import numpy as np

        K = np.asarray(K, float).reshape(3, 3)
        d = np.zeros(5)
        if D is not None:
            D = np.asarray(D, float).ravel()
            d[: min(5, len(D))] = D[:5]
        return cls.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist=d, dtype=dtype)

    @property
    def matrix(self) -> Array:
        """3x3 K matrix."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], axis=-1),
                jnp.stack([z, self.fy, self.cy], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )


def distort_normalized(pts: Array, dist: Array) -> Array:
    """Apply Brown-Conrady distortion to normalized image points ``[..., 2]``."""
    k1, k2, p1, p2, k3 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3], dist[..., 4]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(pts: Array, dist: Array, iters: int = 8) -> Array:
    """Invert Brown-Conrady distortion by fixed-point iteration.

    Same scheme as OpenCV's ``undistortPoints`` inner loop; ``iters`` is a
    static trip count so the loop unrolls and fuses.
    """
    k1, k2, p1, p2, k3 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3], dist[..., 4]
    xd, yd = pts[..., 0], pts[..., 1]

    def body(_, xy):
        x, y = xy
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = p1 * 2.0 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p2 * 2.0 * x * y + p1 * (r2 + 2.0 * y * y)
        return ((xd - dx) / radial, (yd - dy) / radial)

    x, y = jax.lax.fori_loop(0, iters, body, (xd, yd))
    return jnp.stack([x, y], axis=-1)


def project_points(
    points_cam: Array, camera: CameraIntrinsics
) -> Array:
    """Project 3-D camera-frame points ``[..., 3]`` to pixels ``[..., 2]``.

    Pinhole + full distortion; equivalent to ``cv::projectPoints`` with
    identity extrinsics (the reference passes rvec/tvec separately — compose
    with :func:`transform_points` first).
    """
    z = points_cam[..., 2]
    inv_z = 1.0 / z
    norm = points_cam[..., :2] * inv_z[..., None]
    d = distort_normalized(norm, camera.dist)
    u = camera.fx * d[..., 0] + camera.cx
    v = camera.fy * d[..., 1] + camera.cy
    return jnp.stack([u, v], axis=-1)


def transform_points(R: Array, t: Array, points: Array) -> Array:
    """Rigid transform: ``R [...,3,3] @ points [...,N,3] + t [...,3]``."""
    return points @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def pixels_to_normalized(pts: Array, camera: CameraIntrinsics, undistort: bool = True) -> Array:
    """Pixel coords ``[..., 2]`` -> undistorted normalized image coords."""
    x = (pts[..., 0] - camera.cx) / camera.fx
    y = (pts[..., 1] - camera.cy) / camera.fy
    norm = jnp.stack([x, y], axis=-1)
    if undistort:
        norm = undistort_normalized(norm, camera.dist)
    return norm
