"""Typed configuration system (L0).

Replaces the reference's ROS parameter-server plumbing
(launch/slam.launch:43-45 loading parameters.yaml; reads at
src/aruco_slam_node.cpp:50-51,146-165) with strict typed dataclasses.

Parameter names and defaults mirror the reference's ``parameters.yaml``
exactly. Unknown YAML keys are hard errors — the reference silently fell
back to a default when a key was misspelled (the
``const/USEFUL_DISTANCE_THRESHOLD_`` trailing-underscore bug,
src/aruco_slam_node.cpp:161 vs parameters.yaml:31, which made the
*effective* gate 3 m instead of the configured 4 m). We default to the
reference's effective value (3.0) and make the key loadable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

UPDATE_BACKENDS = ("auto", "xla", "triton")


class ConfigError(ValueError):
    pass


ARUCO_ORIGINAL_DICT_ID = 16  # cv::aruco::DICT_ARUCO_ORIGINAL (parameters.yaml:16)


@dataclass(frozen=True)
class NoiseConfig:
    """EKF noise coefficients (parameters.yaml:4-8)."""

    Q_k: float = 0.01
    R_x: float = 100.0
    R_y: float = 100.0
    R_theta: float = 10.0


@dataclass(frozen=True)
class OdomConfig:
    """Differential-drive geometry (parameters.yaml:10-13)."""

    kl: float = 0.05  # left wheel radius [m]
    kr: float = 0.05  # right wheel radius [m]
    b: float = 0.09  # half wheelbase [m]


@dataclass(frozen=True)
class ArucoConfig:
    """Marker dictionary + size (parameters.yaml:15-17)."""

    markers_dictionary: int = ARUCO_ORIGINAL_DICT_ID
    marker_length: float = 0.27
    # PnP Gauss-Newton trip count (settle-2 dual start + finish). The
    # corner-level replay is sequential-depth bound and accuracy saturates
    # by ~4 iterations (pose error flat 4..14 iters, shallow-angle flip
    # rate 0/400 at 6 — benchmarks/pnp_iters_probe.py); 6 keeps margin.
    pnp_refine_iters: int = 6


@dataclass(frozen=True)
class FrameConfig:
    """Frame names (parameters.yaml:19-22); kept for config parity."""

    world_frame: str = "world"
    camera_frame_optical: str = "camera_frame_optical"
    robot_frame_base: str = "base_link"


@dataclass(frozen=True)
class CompatConfig:
    """Per-quirk compatibility switches (SURVEY.md section 7.1).

    Each flag reproduces (True) or fixes (False) a documented reference
    quirk. Defaults reproduce the reference's *effective* behavior.
    """

    # Quirk (b): process noise uses kl for BOTH wheels (src/aruco_slam.cpp:62).
    process_noise_uses_kl_for_both_wheels: bool = True
    # Quirk (c)/effective: skip the correction when a marker was seen last
    # frame with a near-identical measurement (src/aruco_slam.cpp:192-198;
    # the "pose-only" update there is an empty-block no-op).
    stationary_gate: bool = True
    stationary_gate_eps: float = 0.01
    # Quirk (d): divergence check is log-only (src/aruco_slam.cpp:156-175).
    # False = log-only (count it); True = actually reject the update.
    reject_divergent: bool = False
    divergence_ze_norm: float = 1.0
    divergence_k_norm: float = 10.0


@dataclass(frozen=True)
class EkfConfig:
    """Capacity and numerics of the fixed-shape EKF state."""

    max_landmarks: int = 64
    max_observations_per_frame: int = 16
    # Re-symmetrize sigma after each update (f32 hygiene; the f64 reference
    # relies on exact symmetric arithmetic it doesn't quite have either).
    symmetrize_sigma: bool = True
    # Run each frame's sequential per-marker corrections fused in the
    # observed-slot subspace (models/ekf.update_fused): algebraically exact
    # vs the sequential scan, one [N, N] covariance touch per frame instead
    # of one per observation. Requires at most one observation per marker id
    # per frame (the front-end guarantees this; disable for exotic inputs).
    fused_update: bool = False
    # Frame-step backend of batched replay (runner.use_frame_kernel):
    # "auto" runs the Triton frame kernels (ops/kernels/) on a GPU when the
    # map fits the kernel's covariance tile and the vmapped XLA scan
    # otherwise; "triton" and "xla" force one. Results agree to float32
    # tolerance (tests/test_pallas_kernels.py).
    update_backend: str = "auto"

    def __post_init__(self):
        if self.update_backend not in UPDATE_BACKENDS:
            raise ConfigError(
                f"update_backend={self.update_backend!r}; expected one of "
                f"{UPDATE_BACKENDS}"
            )
        if self.fused_update and self.update_backend == "triton":
            raise ConfigError(
                "fused_update=True is an XLA update; it cannot run with "
                "update_backend='triton'"
            )


@dataclass(frozen=True)
class SlamConfig:
    """Top-level config — union of the reference's parameters.yaml sections."""

    covariance: NoiseConfig = field(default_factory=NoiseConfig)
    odom: OdomConfig = field(default_factory=OdomConfig)
    aruco: ArucoConfig = field(default_factory=ArucoConfig)
    frame: FrameConfig = field(default_factory=FrameConfig)
    compat: CompatConfig = field(default_factory=CompatConfig)
    ekf: EkfConfig = field(default_factory=EkfConfig)
    # Effective reference default is 3.0 (aruco_slam.h:58) because the yaml
    # key was never read; see module docstring.
    useful_distance_threshold: float = 3.0
    # Robot->camera planar translation (the reference takes this from TF and
    # uses translation only, src/aruco_slam.cpp:359-360).
    t_r2c_x: float = 0.0
    t_r2c_y: float = 0.0
    map_file: str | None = None


def _build(cls, data: Mapping[str, Any], path: str):
    if not isinstance(data, Mapping):
        raise ConfigError(f"{path}: expected mapping, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise ConfigError(
                f"{path}: unknown key {key!r} (valid: {sorted(fields)})"
            )
        ftype = fields[key].type
        if dataclasses.is_dataclass(_resolve(ftype)):
            kwargs[key] = _build(_resolve(ftype), value, f"{path}.{key}")
        else:
            kwargs[key] = value
    return cls(**kwargs)


_DATACLASS_REGISTRY = {
    c.__name__: c
    for c in (
        NoiseConfig,
        OdomConfig,
        ArucoConfig,
        FrameConfig,
        CompatConfig,
        EkfConfig,
        SlamConfig,
    )
}


def _resolve(ftype):
    if isinstance(ftype, str):
        return _DATACLASS_REGISTRY.get(ftype, ftype)
    return ftype


# Keys in the reference parameters.yaml that we accept and map onto the new
# schema, so the reference's own config file loads unchanged.
_REFERENCE_KEY_MAP = {
    "topic": None,  # ROS topics — no message bus here; ignored with a note
    "const": ("useful_distance_threshold", "USEFUL_DISTANCE_THRESHOLD"),
    "map": ("map_file", "map_file"),
}


def load_config(path_or_dict) -> SlamConfig:
    """Load a :class:`SlamConfig` from YAML (path or pre-parsed dict).

    Accepts both the new schema and the reference's ``parameters.yaml``
    layout (covariance/odom/aruco/frame/topic/const/map sections).
    """
    if isinstance(path_or_dict, Mapping):
        raw = dict(path_or_dict)
    else:
        import yaml  # optional dependency, needed only for YAML files

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, Mapping):
            raise ConfigError(f"{path_or_dict}: top level must be a mapping")
        raw = dict(raw)

    flat: dict[str, Any] = {}
    for section, mapping in _REFERENCE_KEY_MAP.items():
        if section in raw:
            value = raw.pop(section)
            if mapping is None:
                continue
            target, src_key = mapping
            if isinstance(value, Mapping) and src_key in value:
                flat[target] = value[src_key]
    raw.update(flat)
    return _build(SlamConfig, raw, "config")
