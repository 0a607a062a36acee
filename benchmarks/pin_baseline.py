"""Measure and pin the CPU reference baseline (VERDICT round-1 weak #3).

The reference-equivalent single-thread CPU pipeline (cv2 IPPE PnP + dense
float64 NumPy EKF) varies ~2x with host load when measured live inside
bench.py, which made the driver's ``vs_baseline`` metric noisy. This script
measures it N times, reports the median, and that median is recorded as
``PINNED_BASELINE_FPS`` in bench.py (and BASELINE.md). bench.py then only
does a single cheap drift re-measure and warns if it strays >2.5x from the
pin. Pure CPU — no jax import, safe to run any time.
"""

import json
import statistics
import sys
from typing import NamedTuple

import numpy as np

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu.sim import synthetic


class _HostCamera(NamedTuple):
    """Numpy-only stand-in for ops.camera.CameraIntrinsics — keeps this
    script off the (possibly remote) accelerator entirely."""

    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    dist: np.ndarray


def main(n_runs: int = 7):
    import bench

    cam = _HostCamera(
        np.float64(600.0), np.float64(600.0), np.float64(320.0),
        np.float64(240.0), np.zeros(5),
    )
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=60.0, seed=0), level="corners", camera=cam,
    )
    fps = []
    for i in range(n_runs):
        v = bench.bench_reference_numpy(seq)
        fps.append(v)
        print(f"run {i}: {v:.1f} fps", file=sys.stderr)
    med = statistics.median(fps)
    print(json.dumps({"runs": [round(v, 1) for v in fps], "median_fps": round(med, 1)}))


if __name__ == "__main__":
    main()
