"""Saturated detector cost at max_candidates 16 vs 24 (round 5)."""
import os, sys, time, dataclasses
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax.numpy as jnp
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops.detector import DetectorConfig
from aruco_slam_tpu.sim import synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=13.0, seed=0), level="images", camera=CAM)
imgs = jnp.asarray(np.concatenate([np.asarray(seq.images)[:128]] * 10)[:1280])
jax.block_until_ready(imgs)
for label, cfg in (
    ("K24", DetectorConfig()),
    ("K16", dataclasses.replace(DetectorConfig(), max_candidates=16)),
):
    out = runner.detect_frames(imgs, cfg, 16)
    np.asarray(out[0])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.detect_frames(imgs, cfg, 16)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best/1280*1e3:.3f} ms/frame ({1280/best:.1f} fps)", flush=True)

import dataclasses as _dc
for label, cfg in (("K20", _dc.replace(DetectorConfig(), max_candidates=20)),):
    out = runner.detect_frames(imgs, cfg, 16)
    np.asarray(out[0])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.detect_frames(imgs, cfg, 16)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best/1280*1e3:.3f} ms/frame ({1280/best:.1f} fps)", flush=True)
