import sys, dataclasses
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import external_parity as ep
from aruco_slam_tpu.ops import detector
import cv2

for label, cfg in (
    ("no-union", dataclasses.replace(detector.DetectorConfig(), closing_union=False)),
    ("union", detector.DetectorConfig()),
):
    tot = hits = 0; misses = []
    for name, mk in ep.scene_defs():
        ep.RNG = np.random.default_rng(7)
        im, gt = ep.render_scene(cv2, mk)
        o = set(ep.ours_detect(im, cfg))
        tot += len(gt); hits += len(o & set(gt))
        misses += [(name, i) for i in set(gt) - o]
    print(f"{label}: {hits}/{tot} misses={misses}")
