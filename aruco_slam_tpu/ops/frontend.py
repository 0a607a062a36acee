"""Vision front-end orchestration (L2): corners -> gated EKF observations.

JAX counterpart of ``ArucoSlam::getObservations``
(reference src/aruco_slam.cpp:307-376) minus the detector itself (see
``ops.detector``): batched PnP over a frame's markers, the distance gate,
the reprojection-error covariance heuristic with its norm gate, and the
camera->robot observation mapping. Everything is vmapped/masked — a frame
is a fixed-width array of (possibly invalid) marker slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from aruco_slam_tpu.models.ekf import FrameObservations
from aruco_slam_tpu.ops import pnp
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.utils.config import SlamConfig

Array = jax.Array


def observations_from_corners(
    ids: Array,  # [M] int32
    corners_px: Array,  # [M, 4, 2]
    valid: Array,  # [M] bool
    camera: CameraIntrinsics,
    config: SlamConfig,
) -> FrameObservations:
    """One frame: batched square PnP + gates -> FrameObservations.

    Gates faithful to the reference:
    - range gate on ||tvec|| vs the *effective* 3 m threshold
      (src/aruco_slam.cpp:327-333; key-typo story in SURVEY.md section 5.6),
    - covariance Frobenius-norm gate ||R|| > 1 (src/aruco_slam.cpp:367-368).
    """
    res = pnp.solve_pnp_square_batch(
        corners_px, camera, config.aruco.marker_length,
        config.aruco.pnp_refine_iters,
    )
    t_r2c = jnp.asarray([config.t_r2c_x, config.t_r2c_y], corners_px.dtype)
    z = pnp.camera_observation_to_robot(res.rvec, res.tvec, t_r2c)
    R = pnp.observation_covariance(
        res.rms_px,
        res.tvec,
        corners_px,
        config.aruco.marker_length,
        config.covariance.R_x,
        config.covariance.R_y,
        config.covariance.R_theta,
    )
    dist = jnp.linalg.norm(res.tvec, axis=-1)
    keep = (
        valid
        & (dist <= config.useful_distance_threshold)
        & (jnp.linalg.norm(R, axis=(-2, -1)) <= 1.0)
    )
    return FrameObservations(ids=ids, z=z, R=R, valid=keep)


def observations_direct(ids, z, R, valid) -> FrameObservations:
    """Measurement-level stream passthrough (sim level='obs')."""
    return FrameObservations(ids=ids, z=z, R=R, valid=valid)
