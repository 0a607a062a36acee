"""Sweep detection chunk size on one rendered batch-32 dataset (config3b
shape) — separates the per-dispatch floor amortization from per-chunk
memory effects."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
cpu = jax.devices("cpu")[0]
seqs = []
with jax.default_device(cpu):
    for s in range(2):
        seqs.append(
            synthetic.generate_sequence(
                synthetic.SimParams(duration=10.0, seed=s),
                level="images", camera=CAM,
            )
        )
f = seqs[0].num_frames
data = runner.build_batch_data(seqs, 32, "images")
data = jax.tree.map(jnp.asarray, data)
total = 32 * f
print("frames total", total, flush=True)

for chunk in (16, 32, 64, 128):
    try:
        out = runner.replay_batch(data, cfg, CAM, "images", det_chunk=chunk)
        np.asarray(out.trajectory)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = runner.replay_batch(data, cfg, CAM, "images", det_chunk=chunk)
            jax.block_until_ready(out.trajectory)
            best = min(best, time.perf_counter() - t0)
        print(f"chunk {chunk:4d}: {total/best:8.1f} fps  ({best*1e3/total:6.2f} ms/frame)",
              flush=True)
    except Exception as e:
        print(f"chunk {chunk:4d}: FAILED {type(e).__name__}: {e}", flush=True)
