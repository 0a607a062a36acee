"""Diff closing_union True/False on identical degraded frames."""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector
import dataclasses

sc = sw.scenes()
sw.RNG = np.random.default_rng(42)
frames = {}
for cond_name, fn in sw.conditions():
    for name, img, ids in sc:
        frames[(cond_name, name)] = fn(img)

cfg_u = detector.DetectorConfig()
cfg_n = dataclasses.replace(cfg_u, closing_union=False)
for cond in ("blur_s3", "blur+noise", "noise_s8"):
    for name, img, ids in sc:
        deg = frames[(cond, name)]
        u = sw.ours_ids(deg, cfg_u) & ids
        n = sw.ours_ids(deg, cfg_n) & ids
        if u != n:
            print(cond, name, "union-only:", sorted(u - n), "nounion-only:", sorted(n - u))
print("done")
