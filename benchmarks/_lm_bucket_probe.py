"""Probe: degree-class bucketed landmark reduction vs the sorted
segmented scan (round 3, VERDICT item 3).

The scan form costs the same at 10k/5k whatever the operand width or
layout (benchmarks/_segscan_probe.py) — op-count-bound (~17 associative
-scan passes plus flag logic). The bucketed form groups landmarks by
ceil-pow2 observation degree, so each bucket is one gather + one dense
sum with <2x padding (~4 ops per bucket, <= ~10 buckets), then one
gather restores landmark order.
"""
import os, sys, time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
L = np.asarray(packed.landmarks).shape[0]
N = np.asarray(packed.obs_kf).shape[0]
valid = np.asarray(packed.obs_valid)
obs_lm = np.asarray(packed.obs_lm)

# ---- host-side bucketed tables (vectorized) ------------------------------
rows_v = np.nonzero(valid)[0]
lm_v = obs_lm[valid].astype(np.int64)
deg = np.bincount(lm_v, minlength=L)
print("deg: mean %.1f max %d  Nv %d / N %d" % (deg.mean(), deg.max(), len(rows_v), N))

cls = np.zeros(L, np.int32)
cls[deg > 1] = np.ceil(np.log2(deg[deg > 1])).astype(np.int32)
lm_order = np.argsort(cls, kind="stable")          # landmarks in class order
rank = np.empty(L, np.int64)
rank[lm_order] = np.arange(L)                       # class-sorted position
cls_sorted = cls[lm_order]
cls_start = {}
for c in np.unique(cls):
    cls_start[int(c)] = int(np.searchsorted(cls_sorted, c))

# per-obs: within-landmark position
o = np.argsort(lm_v, kind="stable")
ids_s = lm_v[o]
rows_s = rows_v[o]
seg_start = np.zeros(L + 1, np.int64)
np.cumsum(deg, out=seg_start[1:])
within = np.arange(len(ids_s)) - seg_start[ids_s]

bucket_tabs = []  # (cap, n_b, start_in_rank_order, table)
for c in sorted(cls_start):
    cap = 1 << c
    lms = lm_order[cls_sorted == c]
    n_b = len(lms)
    tab = np.full((n_b, cap), N, np.int64)
    m = cls[ids_s] == c
    tab[rank[ids_s[m]] - cls_start[c], within[m]] = rows_s[m]
    bucket_tabs.append((cap, n_b, tab))
print("buckets:", [(n, cap) for cap, n, _ in bucket_tabs],
      "padded rows:", sum(n * cap for cap, n, _ in bucket_tabs))

tabs_dev = [jnp.asarray(t) for _, _, t in bucket_tabs]
rank_dev = jnp.asarray(rank)


def bucketed(vals):
    flat = vals if vals.ndim == 2 else vals.reshape(vals.shape[0], -1)
    padded = jnp.concatenate([flat, jnp.zeros((1, flat.shape[1]), flat.dtype)])
    parts = [padded[t].sum(axis=1) for t in tabs_dev]
    out_sorted = jnp.concatenate(parts, axis=0)
    return out_sorted[rank_dev].reshape(L, *vals.shape[1:])


def scan_form(vals):
    return ba._seg_sum_lm(vals, packed.obs_lm, L, tables)


R = 20


def make_timed(f, shape):
    x0 = jnp.asarray(np.random.RandomState(0).randn(*shape).astype(np.float32))

    @jax.jit
    def prog(x):
        acc = jnp.zeros((L,) + shape[1:], jnp.float32)
        for i in range(R):
            acc = acc + f(x + jnp.float32(i))
        return acc

    return prog, x0


@jax.jit
def null_prog(x):
    return x + 1.0


def timeit(prog, x0):
    r = prog(x0)
    np.asarray(jax.tree.leaves(r)[0]).ravel()[:1]  # sync
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(prog(x0))
        ts.append(time.perf_counter() - t0)
    return min(ts)


xf = jnp.zeros((4, 4), jnp.float32)
floor = timeit(null_prog, xf)
print("dispatch floor: %.2f ms" % (floor * 1e3))

for shape, name in [((N, 3), "[N,3]"), ((N, 3, 3), "[N,3,3]"), ((N, 12), "[N,12]")]:
    for f, fname in [(scan_form, "scan"), (bucketed, "bucket")]:
        prog, x0 = make_timed(f, shape)
        t = timeit(prog, x0)
        print("%-8s %-8s %8.1f us/call  (floor-corrected)"
              % (name, fname, (t - floor) / R * 1e6))
    # parity
    x0 = jnp.asarray(np.random.RandomState(1).randn(*shape).astype(np.float32))
    a = np.asarray(scan_form(x0))
    b = np.asarray(bucketed(x0))
    print("%-8s parity max|diff| = %.3e" % (name, np.abs(a - b).max()))
