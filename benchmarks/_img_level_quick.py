"""Round-5: image-level pipeline fps at batch 32 (bench.py's
bench_image_level, standalone) + chunk sweep at the shipped defaults."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
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
for chunk in (32, 16, 64):
    out = runner.replay_batch(data, cfg, cam, "images", det_chunk=chunk)
    np.asarray(out.trajectory)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.replay_batch(data, cfg, cam, "images", det_chunk=chunk)
        jax.block_until_ready(out.trajectory)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    print(f"chunk={chunk}: {32 * f / ts[len(ts)//2]:.1f} frames/s/chip "
          f"(reps {[round(t,3) for t in ts]})", flush=True)
