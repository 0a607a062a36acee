import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import external_parity as ep
from aruco_slam_tpu.ops import detector
import cv2
from scipy.ndimage import binary_closing

markers = dict(ep.scene_defs())["ext_shallow"]
ep.RNG = np.random.default_rng(7)
img, gt = ep.render_scene(cv2, markers)
cfg = detector.DetectorConfig()
fg = np.asarray(detector.adaptive_threshold(jnp.asarray(img), cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride))
fgc = binary_closing(fg, np.ones((3,3)))
labels = np.asarray(detector.label_components(jnp.asarray(fgc), cfg.ccl_rounds)).reshape(480, 640)
g = np.asarray(gt[150])
x0, x1 = int(g[:,0].min())-4, int(g[:,0].max())+5
y0, y1 = int(g[:,1].min())-4, int(g[:,1].max())+5
sub = labels[y0:y1, x0:x1]; fsub = fgc[y0:y1, x0:x1]
roots, counts = np.unique(sub[fsub], return_counts=True)
print("components (closed fg):", sorted(counts.tolist(), reverse=True)[:5])
# full detect with closing: monkeypatch threshold to close
orig = detector.adaptive_threshold
def closed_thr(img_, r, C, ms=1):
    fg_ = orig(img_, r, C, ms)
    d = fg_
    for dy in (-1,0,1):
        for dx in (-1,0,1):
            d = d | jnp.roll(fg_, (dy,dx), (0,1))
    e = d
    for dy in (-1,0,1):
        for dx in (-1,0,1):
            e = e & jnp.roll(d, (dy,dx), (0,1))
    return e
detector.adaptive_threshold = closed_thr
tot = hits = 0; misses = []; falses = 0
for name, mk in ep.scene_defs():
    ep.RNG = np.random.default_rng(7)
    im, g2 = ep.render_scene(cv2, mk)
    o = set(ep.ours_detect(im, cfg))
    tot += len(g2); hits += len(o & set(g2)); falses += len(o - set(g2))
    misses += [(name, i) for i in set(g2) - o]
print(f"with closing: {hits}/{tot} false={falses} misses={misses}")
