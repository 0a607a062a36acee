"""Quantify the chunk-8 vs chunk-32 detection differences seen in
detect_chunk_probe: how many frames differ and how."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=10.0, seed=0), level="images", camera=CAM
    )
imgs = np.asarray(seq.images)
stack = jnp.asarray(np.concatenate([imgs, imgs, imgs][:2])[:128])
jax.block_until_ready(stack)

runs = {}
for tag, chunk in (("c8a", 8), ("c8b", 8), ("c32a", 32), ("c32b", 32)):
    ids, corners, valid = runner.detect_frames(stack, chunk=chunk)
    runs[tag] = (np.asarray(ids), np.asarray(valid))
    print(tag, "total detections", int(runs[tag][1].sum()), flush=True)

for a, b in (("c8a", "c8b"), ("c32a", "c32b"), ("c8a", "c32a")):
    ia, va = runs[a]
    ib, vb = runs[b]
    diff = []
    for f in range(va.shape[0]):
        sa = sorted(ia[f][va[f]].tolist())
        sb = sorted(ib[f][vb[f]].tolist())
        if sa != sb:
            diff.append((f, sa, sb))
    print(f"{a} vs {b}: {len(diff)} differing frames", flush=True)
    for f, sa, sb in diff[:5]:
        print("  frame", f, sa, "vs", sb, flush=True)
