"""Full parity-sweep comparison: default vs fg-closing, identical frames."""
import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
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

orig = detector.adaptive_threshold
def closed_thr(img_, r, C, ms=1):
    fg_ = orig(img_, r, C, ms)
    h, w = fg_.shape
    ri = jnp.arange(h)[:, None]; ci = jnp.arange(w)[None, :]
    def sh(x, dy, dx, fill):
        y = jnp.roll(x, (dy, dx), (0, 1))
        if dy > 0: y = jnp.where(ri < dy, fill, y)
        if dy < 0: y = jnp.where(ri >= h + dy, fill, y)
        if dx > 0: y = jnp.where(ci < dx, fill, y)
        if dx < 0: y = jnp.where(ci >= w + dx, fill, y)
        return y
    dil = fg_
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx: dil = dil | sh(fg_, dy, dx, False)
    ero = dil
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx: ero = ero & sh(dil, dy, dx, True)
    return ero

for label in ("default", "closed"):
    detector.adaptive_threshold = orig if label == "default" else closed_thr
    cfg = detector.DetectorConfig()
    base = {}
    for name, img, ids in sc:
        base[name] = (sw.ours_ids(img, cfg) & ids) | (cv_cache[("clean", name)] & ids)
    print("==", label)
    for cond_name, _ in sw.conditions():
        tot = hits = cvh = fo = 0
        for name, img, ids in sc:
            det_set = base[name]
            deg = frames[(cond_name, name)]
            o = sw.ours_ids(deg, cfg)
            c = cv_cache[(cond_name, name)] & ids
            tot += len(det_set); hits += len((o & ids) & det_set)
            cvh += len(c & det_set); fo += len(o - ids)
        print("  %-15s ours %2d/%d cv2 %2d/%d false %d%s"
              % (cond_name, hits, tot, cvh, tot, fo,
                 "  <-- below cv2" if hits < cvh else ""), flush=True)
