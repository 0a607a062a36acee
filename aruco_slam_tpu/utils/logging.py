"""Structured run records + profiling helpers (L4 observability).

Replaces the reference's printf-style ROS_INFO_STREAM dumps of mu/sigma
every frame (src/aruco_slam.cpp:79-83,283-286) and its rviz-topic metrics
bus (SURVEY.md section 5.5) with:

- per-frame JSONL records (pose, covariance trace, landmark count,
  innovation statistics) written once per replay from the device arrays —
  no host sync inside the hot loop;
- ``trace`` — a context manager around ``jax.profiler`` for capturing
  device traces to TensorBoard format.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np


def write_replay_log(path: str, result, every: int = 1) -> int:
    """Write per-frame records from a ReplayResult to JSONL. Returns the
    number of records written."""
    traj = np.asarray(result.trajectory)
    covs = np.asarray(result.pose_cov)
    n_lm = np.asarray(result.n_landmarks)
    n = 0
    with open(path, "w") as f:
        for i in range(0, len(traj), every):
            rec = {
                "frame": i,
                "x": float(traj[i, 0]),
                "y": float(traj[i, 1]),
                "theta": float(traj[i, 2]),
                "cov_trace": float(np.trace(covs[i])),
                "n_landmarks": int(n_lm[i]),
            }
            f.write(json.dumps(rec) + "\n")
            n += 1
        summary = {
            "final": True,
            "frames": len(traj),
            "diverged": int(result.final_state.diverged),
            "dropped": int(result.final_state.dropped),
        }
        f.write(json.dumps(summary) + "\n")
    return n


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timing with device sync, for benchmarks."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
