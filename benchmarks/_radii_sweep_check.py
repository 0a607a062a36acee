"""Round-5 task 8: measure the OpenCV-equivalent multi-window adaptive
threshold sweep (adaptive_radii=(3, 7, 11), union + id-dedup through the
existing machinery) against the shipped single-radius-7 + closing-union
default, across the 10 adverse conditions. Recall deltas decide whether
the sweep ships.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector

sc = sw.scenes()
sw.RNG = np.random.default_rng(42)
frames = {}
for cond_name, fn in sw.conditions():
    for name, img, ids in sc:
        frames[(cond_name, name)] = fn(img)

import jax.numpy as jnp

variants = [
    ("default(r7+close)", detector.DetectorConfig()),
    (
        "radii(3,7,11)+close",
        dataclasses.replace(
            detector.DetectorConfig(), adaptive_radii=(3, 7, 11)
        ),
    ),
]
conds = [c for c, _ in sw.conditions()]
for label, cfg in variants:
    det_jit = jax.jit(lambda im, c=cfg: detector.detect_markers(im, c))
    row = {}
    for cond_name in conds:
        hits = fo = 0
        for name, img, ids in sc:
            d = det_jit(jnp.asarray(frames[(cond_name, name)]))
            o = set(int(i) for i in np.asarray(d.ids)[np.asarray(d.valid)])
            hits += len(o & ids)
            fo += len(o - ids)
        row[cond_name] = (hits, fo)
    print(label, row, flush=True)
    jax.clear_caches()
