"""Round-5: split image-level pipeline time into detect_frames vs the rest
on the SAME 1920-frame workload (batch 32 x 60 frames, chunk 16)."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops.detector import DetectorConfig
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
cpu = jax.devices("cpu")[0]
seqs = []
with jax.default_device(cpu):
    for s in range(2):
        seqs.append(synthetic.generate_sequence(
            synthetic.SimParams(duration=6.0, seed=s), level="images", camera=cam))
f = seqs[0].num_frames
data = runner.build_batch_data(seqs, 32, "images")
data = jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None, data)
cam = seqs[0].camera()
dcfg = DetectorConfig()
n = 32 * f

def timed(label, fn):
    out = fn()
    jax.block_until_ready(out)
    np.asarray(jax.tree.leaves(out)[0])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best:.3f}s = {best/n*1e3:.3f} ms/frame ({n/best:.1f} fps)",
          flush=True)
    return out

dets = timed("detect_only   ", lambda: runner.detect_frames(data.images, dcfg, 16))
corner = runner._corner_data_from_detections(data, *dets)
timed("corner_replay ", lambda: runner.replay_batch(corner, cfg, cam, "corners"))
timed("full_pipeline ", lambda: runner.replay_batch(data, cfg, cam, "images", det_chunk=16))
