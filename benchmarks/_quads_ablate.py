"""Intra-quads ablation: stats+topk vs window takes vs corner chain."""
import os, sys, time
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
B = 20
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=2.0, seed=0), level="images", camera=CAM)
imgs = jnp.asarray(np.asarray(seq.images)[:B])
jax.block_until_ready(imgs)
CFG = det.DetectorConfig()

def timeit(fn, *a, reps=5):
    out = fn(*a); np.asarray(jax.tree.leaves(out)[0])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter(); out = fn(*a); jax.block_until_ready(out); ts.append(time.perf_counter()-t0)
    return min(ts)

def stage(upto):
    cfg = CFG
    def run(img):
        fg, labels = det._threshold_and_label(img, cfg.adaptive_radius, cfg)
        if upto == "base":
            return labels.sum()
        h, w = fg.shape
        n = h * w
        st = cfg.stats_stride
        labels2d = labels.reshape(h, w)
        lab_ds = labels2d[::st, ::st]
        fg_ds = fg[::st, ::st]
        hs, ws = lab_ds.shape
        cellf = lab_ds.reshape(-1)
        fgf = fg_ds.reshape(-1)
        big = jnp.int32(n)
        counts = jnp.zeros((n,), jnp.int32).at[cellf].add(fgf.astype(jnp.int32))
        gy = (jnp.arange(hs, dtype=jnp.int32) * st)[:, None]
        gx = (jnp.arange(ws, dtype=jnp.int32) * st)[None, :]
        px_y = jnp.broadcast_to(gy, (hs, ws)).reshape(-1)
        px_x = jnp.broadcast_to(gx, (hs, ws)).reshape(-1)
        bb_minx = jnp.full((n,), big, jnp.int32).at[cellf].min(jnp.where(fgf, px_x, big))
        bb_maxx = jnp.full((n,), -1, jnp.int32).at[cellf].max(jnp.where(fgf, px_x, -1))
        bb_miny = jnp.full((n,), big, jnp.int32).at[cellf].min(jnp.where(fgf, px_y, big))
        bb_maxy = jnp.full((n,), -1, jnp.int32).at[cellf].max(jnp.where(fgf, px_y, -1))
        if upto == "scatters":
            return counts.sum() + bb_minx.sum() + bb_maxx.sum() + bb_miny.sum() + bb_maxy.sum()
        min_ds = max(1, cfg.min_component_pixels // (st * st) // 2)
        max_ds = jnp.int32(cfg.max_component_fraction * (n // (st * st)))
        ok = (counts >= min_ds) & (counts <= max_ds)
        score = jnp.where(ok, counts, 0)
        svals, cells_k = jax.lax.top_k(score.astype(jnp.float32), cfg.max_candidates)
        if upto == "topk":
            return svals.sum() + cells_k.sum()
        roots = cells_k.astype(jnp.int32)
        c_x0 = jnp.maximum(bb_minx[cells_k] - (st - 1), 0)
        c_x1 = jnp.minimum(bb_maxx[cells_k] + (st - 1), w - 1)
        c_y0 = jnp.maximum(bb_miny[cells_k] - (st - 1), 0)
        c_y1 = jnp.minimum(bb_maxy[cells_k] + (st - 1), h - 1)
        Wn = cfg.corner_window
        span = jnp.arange(Wn, dtype=jnp.int32)
        def win(root, x0, x1, y0, y1):
            extent = jnp.maximum(x1 - x0, y1 - y0) + 1
            stride = jnp.maximum((extent + Wn - 1) // Wn, 1)
            wy = jnp.clip(y0 + stride * span, 0, h - 1)
            wx = jnp.clip(x0 + stride * span, 0, w - 1)
            rows = jnp.take(labels2d, wy, axis=0)
            lab_w = jnp.take(rows, wx, axis=1)
            return (lab_w == root).sum()
        s = jax.vmap(win)(roots, c_x0, c_x1, c_y0, c_y1)
        return s.sum()
    return jax.jit(jax.vmap(run))

for name in ["base", "scatters", "topk", "windows"]:
    t = timeit(stage(name), imgs)
    print(f"{name:9s}: {1e3*t/B:7.3f} ms/frame", flush=True)
# full extract_quads for the chain delta
f = jax.jit(jax.vmap(lambda im: det.extract_quads(det._threshold_and_label(im, CFG.adaptive_radius, CFG)[1], det._threshold_and_label(im, CFG.adaptive_radius, CFG)[0], CFG)[0].sum()))
def g(img):
    fg, labels = det._threshold_and_label(img, CFG.adaptive_radius, CFG)
    q, v = det.extract_quads(labels, fg, CFG)
    return q.sum() + v.sum()
t = timeit(jax.jit(jax.vmap(g)), imgs)
print(f"fullquads: {1e3*t/B:7.3f} ms/frame", flush=True)
