import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from aruco_slam_tpu.ops import detector
import detector_parity_sweep as sw
import cv2

d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_ARUCO_ORIGINAL)
cv_det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())
sc = sw.scenes()
for label, cfg in [("C7", detector.DetectorConfig()),
                   ("C5", detector.DetectorConfig(adaptive_C=5.0)),
                   ("C5_r5_11", detector.DetectorConfig(adaptive_C=5.0, adaptive_radii=(5, 11)))]:
    base = {}
    for name, img, ids in sc:
        o = sw.ours_ids(img, cfg) & ids
        c = sw.cv2_ids(img, cv_det) & ids
        base[name] = o | c
    print(f"== {label}")
    for cond_name, fn in sw.conditions():
        tot = hits = cvh = fo = 0
        for name, img, ids in sc:
            det_set = base[name]
            deg = fn(img)
            o = sw.ours_ids(deg, cfg)
            c = sw.cv2_ids(deg, cv_det) & ids
            tot += len(det_set); hits += len((o & ids) & det_set); cvh += len(c & det_set)
            fo += len(o - ids)
        flag = "  <-- below cv2" if hits < cvh else ""
        print(f"  {cond_name:15s}: ours {hits:2d}/{tot} cv2 {cvh:2d}/{tot} false {fo}{flag}", flush=True)
