"""Does denser cell sampling recover the blur+noise miss without regression?"""
import sys, dataclasses
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector

sc = sw.scenes()
sw.RNG = np.random.default_rng(42)
frames = {}
for cond_name, fn in sw.conditions():
    for name, img, ids in sc:
        frames[(cond_name, name)] = fn(img)

base_cfg = detector.DetectorConfig()
import os
sel = os.environ.get("VARIANT")
variants = [
    ("default(cs=2)", base_cfg),
    ("cs=3", dataclasses.replace(base_cfg, cell_samples=3)),
    ("cs=3+vote", dataclasses.replace(base_cfg, cell_samples=3, cell_vote=True)),
    ("cs=4", dataclasses.replace(base_cfg, cell_samples=4)),
    ("cs=4+vote", dataclasses.replace(base_cfg, cell_samples=4, cell_vote=True)),
]
conds = [c for c, _ in sw.conditions()]
variants = [v for v in variants if sel is None or v[0] == sel]
for label, cfg in variants:
    row = {}
    for cond_name in conds:
        hits = fo = 0
        for name, img, ids in sc:
            o = sw.ours_ids(frames[(cond_name, name)], cfg)
            hits += len(o & ids); fo += len(o - ids)
        row[cond_name] = (hits, fo)
    print(label, {k: v for k, v in row.items()}, flush=True)
