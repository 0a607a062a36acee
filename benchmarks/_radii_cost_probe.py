"""Round-5 task 8 cost row: saturated detector ms/frame with the
adaptive_radii=(3,7,11) sweep vs the shipped default (1280-frame stack,
chunk 16 — the honest measurement shape, CLAUDE.md gotcha 11)."""
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
base = np.asarray(seq.images)[:128]
imgs = jnp.asarray(np.concatenate([base] * 10)[:1280])
jax.block_until_ready(imgs)
for label, cfg in (
    ("default", DetectorConfig()),
    ("radii_3_7_11", dataclasses.replace(DetectorConfig(), adaptive_radii=(3, 7, 11))),
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
