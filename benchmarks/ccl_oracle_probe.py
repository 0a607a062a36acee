"""Validate scan-accelerated CCL against scipy.ndimage.label (8-connected)
and find the round count needed for exact convergence on realistic and
adversarial masks."""
import sys

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from scipy import ndimage

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic

CFG = det.DetectorConfig()
S8 = np.ones((3, 3), bool)  # 8-connectivity structure


def check(fg_np, rounds):
    labels = np.asarray(
        jax.jit(lambda m: det.label_components(m, rounds), static_argnums=())(
            jnp.asarray(fg_np)
        )
    ).reshape(fg_np.shape)
    ref, nref = ndimage.label(fg_np, structure=S8)
    ok = True
    # exact CCL: our labels must be constant within each scipy component and
    # distinct across components
    seen = {}
    for comp in range(1, nref + 1):
        vals = np.unique(labels[ref == comp])
        if len(vals) != 1:
            ok = False
            break
        if vals[0] in seen:
            ok = False
            break
        seen[vals[0]] = comp
    return ok, nref


def masks():
    out = []
    # rendered scenes
    CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=2.0, seed=0), level="images", camera=CAM
    )
    for i in (0, 7, 13, 19):
        img = jnp.asarray(np.asarray(seq.images)[i])
        fg = np.asarray(det.adaptive_threshold(img, CFG.adaptive_radius, CFG.adaptive_C))
        out.append(("rendered%d" % i, fg))
    rng = np.random.default_rng(0)
    # random blobs
    blob = ndimage.binary_dilation(rng.random((480, 640)) > 0.995, iterations=6)
    out.append(("blobs", blob))
    # dense noise (many tiny components, heavy merge load)
    out.append(("noise", rng.random((480, 640)) > 0.6))
    # adversarial: large tilted thin frame (quad border at 30 deg)
    img = np.full((480, 640), 255, np.uint8)
    import math
    c, s = math.cos(0.5), math.sin(0.5)
    for t in np.linspace(0, 3.9999, 4001):
        edge = int(t)
        u = t - edge
        pts = [(-150, -150), (150, -150), (150, 150), (-150, 150), (-150, -150)]
        x0, y0 = pts[edge]
        x1, y1 = pts[edge + 1]
        x, y = x0 + u * (x1 - x0), y0 + u * (y1 - y0)
        xr, yr = c * x - s * y + 320, s * x + c * y + 240
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                yy, xx = int(yr) + dy, int(xr) + dx
                if 0 <= yy < 480 and 0 <= xx < 640:
                    img[yy, xx] = 0
    fg = np.asarray(det.adaptive_threshold(jnp.asarray(img), CFG.adaptive_radius, CFG.adaptive_C))
    out.append(("tilted-frame", fg))
    # spiral (long geodesic, worst case for propagation)
    sp = np.zeros((480, 640), bool)
    cy, cx = 240, 320
    th = 0.0
    r = 5.0
    while r < 200:
        y, x = int(cy + r * np.sin(th)), int(cx + r * np.cos(th))
        sp[max(0, y - 2): y + 3, max(0, x - 2): x + 3] = True
        th += 0.02
        r += 0.05
    out.append(("spiral", sp))
    return out


for name, fg in masks():
    row = [name]
    for rounds in (2, 4, 6, 8, 12, 16, 24, 32):
        ok, ncomp = check(fg, rounds)
        row.append(f"r{rounds}:{'OK' if ok else 'x'}")
        if ok:
            break
    print(" ".join(row), f"(ncomp={ncomp})", flush=True)
