"""Which marker does cv2 find under blur+noise that we miss, and why?"""
import sys, dataclasses
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
cfg = detector.DetectorConfig()
for name, img, ids in sc:
    deg = frames[("blur+noise", name)]
    o = sw.ours_ids(deg, cfg) & ids
    c = sw.cv2_ids(deg, cv_det) & ids
    if c - o:
        print("scene", name, "cv2-only:", sorted(c - o), "ours:", sorted(o))
        # where is that marker? corners from cv2
        corners, mids, _ = cv_det.detectMarkers(deg)
        for q, i in zip(corners, mids.ravel()):
            if int(i) in (c - o):
                q = q.reshape(4, 2)
                print("  id", int(i), "extent",
                      (q.max(0) - q.min(0)).round(1), "at", q.mean(0).round(1))
                # fg fragmentation at that spot?
                fg = np.asarray(detector.adaptive_threshold(
                    jnp.asarray(deg), cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride))
                x0, x1 = int(q[:,0].min())-4, int(q[:,0].max())+5
                y0, y1 = int(q[:,1].min())-4, int(q[:,1].max())+5
                lab = np.asarray(detector.label_components(jnp.asarray(fg), cfg.ccl_rounds)).reshape(fg.shape)
                sub = lab[y0:y1, x0:x1]; fsub = fg[y0:y1, x0:x1]
                roots, counts = np.unique(sub[fsub], return_counts=True)
                print("  raw components in window:", sorted(counts.tolist(), reverse=True)[:6])
                fgc = np.asarray(detector.binary_close3(jnp.asarray(fg)))
                labc = np.asarray(detector.label_components(jnp.asarray(fgc), cfg.ccl_rounds)).reshape(fg.shape)
                subc = labc[y0:y1, x0:x1]; fsubc = fgc[y0:y1, x0:x1]
                rc_, cc_ = np.unique(subc[fsubc], return_counts=True)
                print("  closed components in window:", sorted(cc_.tolist(), reverse=True)[:6])

# which gate kills the candidate? re-run detect internals on that frame
deg = frames[("blur+noise", "shallow2")]
img_j = jnp.asarray(deg)
q, v = detector.extract_quads(
    np.asarray(detector.label_components(jnp.asarray(detector.adaptive_threshold(img_j, cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride)), cfg.ccl_rounds)).reshape(deg.shape),
    detector.adaptive_threshold(img_j, cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride), cfg)
q = jnp.asarray(q); v = np.asarray(v)
# find the candidate nearest (158.8, 240)
cen = np.asarray(q).mean(1)
dist = np.linalg.norm(cen - np.array([158.8, 240.0]), axis=1)
k = int(np.argmin(np.where(v, dist, 1e9)))
print("candidate", k, "valid", v[k], "quad", np.asarray(q[k]).round(1).tolist())
qq = q
if cfg.subpix_refine:
    extent = jnp.max(jnp.max(qq, axis=1) - jnp.min(qq, axis=1), axis=-1)
    qq = detector.refine_corners_subpix(img_j, qq, window=cfg.subpix_window,
        iters=cfg.subpix_iters, window_small=cfg.subpix_window_small,
        small=extent < cfg.subpix_small_extent)
mids, corners, contrast, berr, ok = detector.decode_candidates(img_j, qq, cfg)
print("decoded id", int(mids[k]), "dict_ok", bool(ok[k]), "border_err", int(berr[k]),
      "contrast", float(contrast[k]))
print("refined quad", np.asarray(qq[k]).round(1).tolist())
