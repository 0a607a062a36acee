"""Corner-level replay throughput vs batch size."""
import os, sys, time
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16))
seqs = [synthetic.generate_sequence(synthetic.SimParams(duration=60.0, seed=s),
                                    level="corners", camera=cam) for s in range(8)]
for batch in (64, 96, 128, 192, 256):
    try:
        data = runner.build_batch_data(seqs, batch, "corners")
        f = data.obs_ids.shape[1]
        out = runner.replay_batch(data, cfg, cam, "corners")
        np.asarray(out.trajectory)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = runner.replay_batch(data, cfg, cam, "corners")
            jax.block_until_ready(out.trajectory)
            best = min(best, time.perf_counter() - t0)
        print(f"batch {batch:4d}: {batch*f/best:10.1f} fps/chip", flush=True)
    except Exception as e:
        print(f"batch {batch:4d}: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
