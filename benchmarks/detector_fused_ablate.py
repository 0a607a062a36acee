"""Fused-pipeline detector ablation at batch 32 (round 3, VERDICT item 1).

Stage-alone timings each include a dispatch floor, so they rank stages
but cannot attribute the fused pipeline's per-frame cost.
This probe times cumulative PREFIXES of the pipeline, each as one jitted
program at production batch — the deltas are the in-program stage costs.
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dataclasses import replace

from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
B = int(os.environ.get("PROBE_B", "32"))
REPS = int(os.environ.get("PROBE_REPS", "5"))

cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=2.0, seed=0), level="images", camera=CAM
    )
imgs = jnp.asarray(np.asarray(seq.images)[:B])
jax.block_until_ready(imgs)
print("imgs", imgs.shape, file=sys.stderr)


def timeit(fn, *args, reps=REPS):
    out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0])  # sync
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def prefix(cfg, upto, subpix_mode="both"):
    """upto: 'ccl' | 'quads' | 'subpix' | 'full'."""

    def run(img):
        fg, labels = det._threshold_and_label(img, cfg.adaptive_radius, cfg)
        if upto == "ccl":
            return labels.sum()
        quads, cand_valid = det.extract_quads(labels, fg, cfg)
        if upto == "quads":
            return quads.sum() + cand_valid.sum()
        if cfg.subpix_refine:
            big = det.refine_corners_subpix(
                img, quads, window=cfg.subpix_window, iters=cfg.subpix_iters
            )
            if subpix_mode == "both":
                small = det.refine_corners_subpix(
                    img, quads, window=cfg.subpix_window_small,
                    iters=cfg.subpix_iters,
                )
                extent = jnp.max(
                    jnp.max(quads, axis=1) - jnp.min(quads, axis=1), axis=-1
                )
                sm = (extent < cfg.subpix_small_extent)[:, None, None]
                quads = jnp.where(sm, small, big)
            else:
                quads = big
        if upto == "subpix":
            return quads.sum()
        return det.detect_markers(img, cfg)

    return jax.jit(jax.vmap(run))


CFG = det.DetectorConfig()
rows = []
for name, cfg, upto, sm in [
    ("thr+ccl (r8)", replace(CFG, ccl_rounds=8), "ccl", "both"),
    ("thr+ccl (r4)", CFG, "ccl", "both"),
    ("+quads", CFG, "quads", "both"),
    ("+subpix both", CFG, "subpix", "both"),
    ("+subpix one", CFG, "subpix", "one"),
    ("full", CFG, "full", "both"),
    ("full (r4)", CFG, "full", "both"),
]:
    t, _ = timeit(prefix(cfg, upto, sm), imgs)
    rows.append((name, 1e3 * t / B))
    print(f"{name:16s}: {1e3*t/B:7.3f} ms/frame", flush=True)

print("\ndeltas:", file=sys.stderr)
base = dict(rows)
print(f"  quads  = {base['+quads'] - base['thr+ccl (r4)']:.3f}")
print(f"  subpix = {base['+subpix both'] - base['+quads']:.3f} (one window: {base['+subpix one'] - base['+quads']:.3f})")
print(f"  decode+gates = {base['full'] - base['+subpix both']:.3f}")
print(f"  ccl r8->r4 saves {base['thr+ccl (r8)'] - base['thr+ccl (r4)']:.3f}")
