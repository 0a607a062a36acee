"""Score the parity sweep with closing_union False vs True (same frames)."""
import sys, dataclasses
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector
import cv2

d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_ARUCO_ORIGINAL)
cv_det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
sc = sw.scenes()
sw.RNG = np.random.default_rng(42)
frames = {}
for cond_name, fn in sw.conditions():
    for name, img, ids in sc:
        frames[(cond_name, name)] = fn(img)
cv_cache = {k: sw.cv2_ids(img, cv_det) for k, img in frames.items()}

for label, cfg in (
    ("no-union", dataclasses.replace(detector.DetectorConfig(), closing_union=False)),
    ("union", detector.DetectorConfig()),
):
    base = {}
    for name, img, ids in sc:
        base[name] = (sw.ours_ids(img, cfg) & ids) | (cv_cache[("clean", name)] & ids)
    print("==", label, "detectable:", sum(len(v) for v in base.values()))
    for cond_name, _ in sw.conditions():
        tot = hits = cvh = fo = 0
        cv_only = []
        for name, img, ids in sc:
            det_set = base[name]
            deg = frames[(cond_name, name)]
            o = sw.ours_ids(deg, cfg)
            c = cv_cache[(cond_name, name)] & ids
            tot += len(det_set); hits += len((o & ids) & det_set)
            cvh += len(c & det_set); fo += len(o - ids)
            cv_only += [(name, i) for i in (c & det_set) - o]
        print(f"  {cond_name:15s} ours {hits:2d}/{tot} cv2 {cvh:2d}/{tot} false {fo} cv2only={cv_only}")
