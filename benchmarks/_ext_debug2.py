import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import external_parity as ep
from aruco_slam_tpu.ops import detector
import cv2

markers = dict(ep.scene_defs())["ext_shallow"]
img, gt = ep.render_scene(cv2, markers)
g = np.asarray(gt[150]); print("gt150:", g.round(1).tolist())
cfg = detector.DetectorConfig()
fg = np.asarray(detector.adaptive_threshold(jnp.asarray(img), cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride))
labels = np.asarray(detector.label_components(jnp.asarray(fg), cfg.ccl_rounds)).reshape(480, 640)
x0, x1 = int(g[:,0].min())-4, int(g[:,0].max())+5
y0, y1 = int(g[:,1].min())-4, int(g[:,1].max())+5
sub = labels[y0:y1, x0:x1]; fsub = fg[y0:y1, x0:x1]
roots, counts = np.unique(sub[fsub], return_counts=True)
print("components in gt bbox:", [(int(r), int(c), (int(r)//640), int(r)%640) for r, c in zip(roots, counts) if c > 10])
print("fg fraction in bbox:", fsub.mean().round(3), "bbox", (x0,x1,y0,y1))
# visualize fg of the biggest component
r = roots[np.argmax(counts)]
m = (sub == r)
for row in range(0, m.shape[0], 2):
    print("".join("#" if m[row, c] else ("." if fsub[row, c] else " ") for c in range(m.shape[1])))
