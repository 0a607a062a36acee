"""Corrected detector-config variant sweep on the OFFICIAL parity harness.

benchmarks/_c5_full_sweep.py was invalid: detector_parity_sweep's
module-level RNG advances across variants, so only the first variant saw
the canonical degraded frames. Here every variant re-seeds the harness
RNG (and pre-generates the degraded frames once) so all variants see
bit-identical inputs.
"""
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
# pre-generate degraded frames ONCE with the canonical RNG sequence:
# conditions outer, scenes inner — the exact order main() consumes it
sw.RNG = np.random.default_rng(42)
frames = {}  # (cond, scene) -> image
for cond_name, fn in sw.conditions():
    for name, img, ids in sc:
        frames[(cond_name, name)] = fn(img)

ALL_VARIANTS = [
    ("C7 (default)", detector.DetectorConfig()),
    ("C5", detector.DetectorConfig(adaptive_C=5.0)),
    ("C6", detector.DetectorConfig(adaptive_C=6.0)),
    ("C7 radii(3,7,11)", detector.DetectorConfig(adaptive_radii=(3, 7, 11))),
    ("C7 radii(7,11)", detector.DetectorConfig(adaptive_radii=(7, 11))),
    ("C6 radii(7,11)", detector.DetectorConfig(adaptive_C=6.0, adaptive_radii=(7, 11))),
]
# run one variant per process (argv index): the multi-radius configs
# compile large CPU programs and several in one process OOM the LLVM JIT
sel = [int(a) for a in sys.argv[1:]] or range(len(ALL_VARIANTS))
variants = [ALL_VARIANTS[i] for i in sel]

cv_cache = {}
for key, img in frames.items():
    cv_cache[key] = sw.cv2_ids(img, cv_det)

for label, cfg in variants:
    base = {}
    for name, img, ids in sc:
        base[name] = (sw.ours_ids(img, cfg) & ids) | (cv_cache[("clean", name)] & ids)
    lines, ok = [], True
    for cond_name, _ in sw.conditions():
        tot = hits = cvh = fo = 0
        for name, img, ids in sc:
            det_set = base[name]
            deg = frames[(cond_name, name)]
            o = sw.ours_ids(deg, cfg)
            c = cv_cache[(cond_name, name)] & ids
            tot += len(det_set)
            hits += len((o & ids) & det_set)
            cvh += len(c & det_set)
            fo += len(o - ids)
        below = hits < cvh
        ok = ok and not below and fo == 0
        lines.append("  %-15s ours %2d/%d cv2 %2d/%d false %d%s"
                     % (cond_name, hits, tot, cvh, tot, fo,
                        "  <-- below cv2" if below else ""))
    print("== %s %s" % (label, "[ALL >= cv2, 0 false]" if ok else ""))
    print("\n".join(lines), flush=True)
