"""Production image-level fps at several detect chunk sizes (round 3)."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp, numpy as np
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
        seqs.append(synthetic.generate_sequence(
            synthetic.SimParams(duration=6.0, seed=s), level="images", camera=CAM))
f = seqs[0].num_frames
batch = 32
data = runner.build_batch_data(seqs, batch, "images")
data = jax.tree.map(lambda x: jnp.asarray(x) if x is not None else None, data)
for chunk in [32, 64, 128, 192]:
    out = runner.replay_batch(data, cfg, CAM, "images", det_chunk=chunk)
    np.asarray(out.trajectory)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.replay_batch(data, cfg, CAM, "images", det_chunk=chunk)
        jax.block_until_ready(out.trajectory)
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    print(f"chunk {chunk:4d}: {batch*f/dt:8.1f} frames/s  ({1e3*dt/(batch*f):.3f} ms/frame)", flush=True)
