import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter
from aruco_slam_tpu.ops import detector
import detector_parity_sweep as sw

RNG = np.random.default_rng(42)
sc = sw.scenes()
import cv2
d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_ARUCO_ORIGINAL)
cv_det = cv2.aruco.ArucoDetector(d, cv2.aruco.DetectorParameters())

def cond(img):
    b = np.clip(gaussian_filter(img.astype(np.float32), 1.5), 0, 255).astype(np.uint8)
    return np.clip(b.astype(np.float32) + RNG.normal(scale=10, size=b.shape), 0, 255).astype(np.uint8)

base = {}
cfg0 = detector.DetectorConfig()
for name, img, ids in sc:
    o = sw.ours_ids(img, cfg0) & ids
    c = sw.cv2_ids(img, cv_det) & ids
    base[name] = o | c

variants = {
    "default": detector.DetectorConfig(),
    "radii_3_7_11": detector.DetectorConfig(adaptive_radii=(3, 7, 11)),
    "radii_7_15": detector.DetectorConfig(adaptive_radii=(7, 15)),
    "radii_5_11": detector.DetectorConfig(adaptive_radii=(5, 11)),
    "C5": detector.DetectorConfig(adaptive_C=5.0),
    "radii_3_7_11_C5": detector.DetectorConfig(adaptive_radii=(3, 7, 11), adaptive_C=5.0),
}
for vn, cfg in variants.items():
    tot = hits = cvh = 0
    for name, img, ids in sc:
        det_set = base[name]
        deg = cond(img)
        o = sw.ours_ids(deg, cfg) & ids
        c = sw.cv2_ids(deg, cv_det) & ids
        tot += len(det_set); hits += len(o & det_set); cvh += len(c & det_set)
    print(f"{vn:18s}: ours {hits}/{tot}  (cv2 {cvh}/{tot})", flush=True)
