import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import external_parity as ep
from aruco_slam_tpu.ops import detector
import cv2

for radii in [(), (3, 7), (5, 7), (3, 7, 15), (5, 11)]:
    cfg = detector.DetectorConfig(adaptive_radii=radii)
    tot = hits = 0; misses = []
    for name, markers in ep.scene_defs():
        ep.RNG = np.random.default_rng(7)
        img, gt = ep.render_scene(cv2, markers)
        o = set(ep.ours_detect(img, cfg))
        tot += len(gt); hits += len(o & set(gt))
        misses += [(name, i) for i in set(gt) - o]
    print(f"radii {radii}: {hits}/{tot} misses={misses}", flush=True)
