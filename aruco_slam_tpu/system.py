"""Online SLAM system (L4) — the reference's ``ArucoSlam`` class surface.

A stateful convenience wrapper over the pure-functional core for live /
streaming use, mirroring the reference API one-to-one so reference users
can switch directly:

=====================================  =====================================
reference (include/aruco_slam/...)      here
=====================================  =====================================
``ArucoSlam(inite_data)``               ``SlamSystem(config)``
``setCameraParameters(K, dist)``        ``set_camera(camera)``
``addEncoder(wl, wr)`` (wall-clock dt)  ``add_encoder(wl, wr, dt)`` (explicit dt)
``addImage(img)``                       ``add_image(img)`` / ``add_corners`` /
                                        ``add_observations``
``toRosPose()``                         ``pose_with_covariance()``
``toRosMappedMarkers()``                ``mapped_markers()``
``toRosDetectedMarkers()``              ``detected_markers()``
``getMarkedImg()``                      ``marked_image()``
=====================================  =====================================

Internally every step is a jitted pure function over ``EkfState``; the
wrapper only holds the latest state + last detections.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu import viz
from aruco_slam_tpu.models import ekf
from aruco_slam_tpu.ops import frontend
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops.detector import DetectorConfig, Detections, detect_markers
from aruco_slam_tpu.utils.config import SlamConfig


class SlamSystem:
    def __init__(
        self,
        config: SlamConfig | None = None,
        camera: Optional[CameraIntrinsics] = None,
        detector_config: DetectorConfig = DetectorConfig(),
    ):
        self.config = config or SlamConfig()
        self.camera = camera
        self.detector_config = detector_config
        self.state = ekf.init_state(self.config)
        self.last_detections: Optional[Detections] = None
        self._last_image = None
        from aruco_slam_tpu.runner import frame_update_for

        self._predict = jax.jit(ekf.predict, static_argnums=2)
        self._update = jax.jit(
            frame_update_for(self.config, batched=False), static_argnums=2
        )
        self._detect = jax.jit(detect_markers, static_argnums=1)
        self._front = jax.jit(
            frontend.observations_from_corners, static_argnums=4
        )

    # -- inputs ------------------------------------------------------------

    def set_camera(self, camera: CameraIntrinsics) -> None:
        """Reference ``setCameraParameters`` (aruco_slam.h:129-133)."""
        self.camera = camera

    def add_encoder(self, wl: float, wr: float, dt: float) -> None:
        """EKF predict from one encoder tick. The reference used wall-clock
        receive time for dt (quirk (a)); here dt is explicit."""
        self.state = self._predict(
            self.state,
            ekf.Control(jnp.float32(wl), jnp.float32(wr), jnp.float32(dt)),
            self.config,
        )

    def add_image(self, img) -> None:
        """Full per-frame pipeline: detect -> PnP -> gate -> EKF update
        (reference ``addImage`` + ``getObservations``)."""
        if self.camera is None:
            raise RuntimeError("set_camera first (reference parses CameraInfo)")
        img = jnp.asarray(img)
        det = self._detect(img, self.detector_config)
        self.last_detections = det
        self._last_image = img
        frame = self._front(
            det.ids, det.corners, det.valid, self.camera, self.config
        )
        self.state = self._update(self.state, frame, self.config)

    def add_corners(self, ids, corners_px, valid) -> None:
        """PnP-level input (detector bypassed)."""
        frame = self._front(
            jnp.asarray(ids, jnp.int32),
            jnp.asarray(corners_px, jnp.float32),
            jnp.asarray(valid),
            self.camera,
            self.config,
        )
        self.state = self._update(self.state, frame, self.config)

    def add_observations(self, ids, z, R, valid) -> None:
        """Measurement-level input."""
        frame = ekf.FrameObservations(
            ids=jnp.asarray(ids, jnp.int32),
            z=jnp.asarray(z, jnp.float32),
            R=jnp.asarray(R, jnp.float32),
            valid=jnp.asarray(valid),
        )
        self.state = self._update(self.state, frame, self.config)

    # -- outputs -----------------------------------------------------------

    def pose(self) -> np.ndarray:
        return np.asarray(self.state.mu[:3])

    def pose_with_covariance(self) -> dict:
        return viz.pose_with_covariance(self.state)

    def mapped_markers(self) -> list:
        return viz.mapped_markers(self.state, self.config)

    def detected_markers(self) -> list:
        if self.last_detections is None:
            return []
        return viz.detected_marker_records(
            self.last_detections, self.config.aruco.marker_length
        )

    def marked_image(self) -> Optional[np.ndarray]:
        """Reference ``getMarkedImg``: last frame with detections drawn."""
        if self._last_image is None or self.last_detections is None:
            return None
        return viz.draw_detections(
            np.asarray(self._last_image), self.last_detections
        )

    def landmark_map(self):
        """(landmarks [n,3], aruco_ids [n]) for the active slots."""
        lms, ids, active = ekf.get_map(self.state, self.config)
        active = np.asarray(active)
        return np.asarray(lms)[active], np.asarray(ids)[active]

    def reset(self) -> None:
        self.state = ekf.init_state(self.config)
        self.last_detections = None
        self._last_image = None
