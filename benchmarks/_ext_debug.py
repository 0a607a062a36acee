import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))); sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import external_parity as ep
from aruco_slam_tpu.ops import detector
import cv2

markers = dict(ep.scene_defs())["ext_shallow"]
img, gt = ep.render_scene(cv2, markers)
print("gt ids:", sorted(gt), "gt150 corners:", gt.get(150))
cfg = detector.DetectorConfig()
det = detector.detect_markers(jnp.asarray(img), cfg)
ids, valid = np.asarray(det.ids), np.asarray(det.valid)
print("ours:", ids[valid])
# where in the pipeline does 150 die?
fg = detector.adaptive_threshold(jnp.asarray(img), cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride)
labels = detector.label_components(fg, cfg.ccl_rounds)
quads, cand_valid = detector.extract_quads(labels, fg, cfg)
q = np.asarray(quads); cv_ = np.asarray(cand_valid)
c150 = np.asarray(gt[150]).mean(axis=0)
for k in range(len(q)):
    if cv_[k] and np.linalg.norm(q[k].mean(axis=0) - c150) < 30:
        print("candidate near 150:", k, q[k].round(1))
        # decode it
        quads_ref = detector.refine_corners_subpix(jnp.asarray(img), quads[k:k+1], window=cfg.subpix_window, iters=cfg.subpix_iters)
        mids, cc, contrast, berr, ok = detector.decode_candidates(jnp.asarray(img), quads_ref, cfg)
        print("decode:", int(mids[0]), "ok", bool(ok[0]), "border_err", float(berr[0]), "contrast", float(contrast[0]))
        break
else:
    print("no candidate near gt150 center", c150)
