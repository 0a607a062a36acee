"""Throughput of the batched detector vs chunk size on the real chip.

Round-1 capped detect_frames at chunk=8 because extract_quads materialized
[chunk, K, H*W] masks; after the bounding-box-window rework the peak is
[chunk, K, W^2]. This probe measures fps and validates detections are
unchanged across chunk sizes.
"""
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

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)

cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=10.0, seed=0), level="images", camera=CAM
    )
imgs = np.asarray(seq.images)  # [F, H, W] uint8
print("frames", imgs.shape, imgs.dtype, file=sys.stderr)

# stack to 256 frames
n_target = 256
reps = -(-n_target // imgs.shape[0])
stack = np.concatenate([imgs] * reps)[:n_target]
dev_stack = jnp.asarray(stack)
jax.block_until_ready(dev_stack)

ref_ids = ref_valid = None
for chunk in (8, 16, 32, 64, 128):
    try:
        # warm (compile)
        ids, corners, valid = runner.detect_frames(dev_stack, chunk=chunk)
        jax.block_until_ready(valid)
        t0 = time.time()
        for _ in range(3):
            ids, corners, valid = runner.detect_frames(dev_stack, chunk=chunk)
            jax.block_until_ready(valid)
        dt = (time.time() - t0) / 3
        ids_n, valid_n = np.asarray(ids), np.asarray(valid)
        if ref_ids is None:
            ref_ids, ref_valid = ids_n, valid_n
            match = True
        else:
            match = bool(
                np.array_equal(valid_n, ref_valid)
                and np.array_equal(np.where(ref_valid, ids_n, -1),
                                   np.where(ref_valid, ref_ids, -1))
            )
        print(f"chunk={chunk:4d}: {n_target/dt:9.1f} fps  match={match}",
              flush=True)
    except Exception as e:
        print(f"chunk={chunk:4d}: FAILED {type(e).__name__}: {str(e)[:200]}",
              flush=True)
