"""Probe: bucket-class merge threshold vs CG-iteration cost at 10k/5k.

build_tables merges degree classes with < MERGE padded rows upward; large
MERGE = fewer gather launches but more padding rows (gather cost is
per-row). Sweep the threshold and time the real
gn-step (unrolled, cg=50)."""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables0, static = ba.prepare(problem)


def tables_with_threshold(merge):
    """Rebuild only the degree-class tables with a custom merge point."""
    L = 5000
    N = packed.obs_kf.shape[0]
    valid = np.asarray(packed.obs_valid)
    rows_v = np.nonzero(valid)[0]
    obs_lm = np.asarray(packed.obs_lm)[valid]
    order = np.argsort(obs_lm, kind="stable")
    lm_sort_rows = rows_v[order].astype(np.int32)
    sorted_ids = obs_lm[order]
    nv = len(sorted_ids)
    counts = np.bincount(sorted_ids, minlength=L)
    cum = np.cumsum(counts)
    deg = counts
    cls = np.zeros(L, np.int64)
    cls[deg > 1] = np.ceil(np.log2(deg[deg > 1])).astype(np.int64)
    uniq = np.unique(cls)
    for i in range(len(uniq) - 1):
        c = uniq[i]
        if int((cls == c).sum()) << int(c) < merge:
            cls[cls == c] = uniq[i + 1]
    lm_order = np.argsort(cls, kind="stable")
    rank = np.empty(L, np.int64)
    rank[lm_order] = np.arange(L)
    cls_sorted = cls[lm_order]
    within = np.arange(nv) - (cum[sorted_ids] - counts[sorted_ids])
    bucket_tabs = []
    total_rows = 0
    for c in np.unique(cls):
        sel = cls_sorted == c
        start = int(np.searchsorted(cls_sorted, c))
        tab = np.full((int(sel.sum()), 1 << int(c)), N, np.int64)
        m = cls[sorted_ids] == c
        tab[rank[sorted_ids[m]] - start, within[m]] = lm_sort_rows[m]
        total_rows += tab.size
        bucket_tabs.append(jnp.asarray(tab.astype(np.int32)))
    t = tables0._replace(
        lm_bucket_tabs=tuple(bucket_tabs),
        lm_rank=jnp.asarray(rank.astype(np.int32)),
    )
    return t, len(bucket_tabs), total_rows


@jax.jit
def null_prog(x):
    return x + 1.0


def timeit(prog, *args, reps=5):
    out = prog(*args)
    np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jax.tree.leaves(prog(*args))[0])
        ts.append(time.perf_counter() - t0)
    return min(ts)


floor = timeit(null_prog, jnp.zeros((4, 4), jnp.float32))
print(f"floor {floor*1e3:.2f} ms  (N real rows = 80000)", flush=True)

ref = None
for merge in (8192, 2048, 512, 128, 0):
    tabs, n_class, rows = tables_with_threshold(merge)
    f = jax.jit(
        lambda pt, tb=tabs: ba.solve(
            pt, iters=2, cg_iters=50, damping=1e-4, tables=tb, unroll=True,
            **static
        )
    )
    t = (timeit(f, packed) - floor) / 2
    out = np.asarray(f(packed)[0])
    if ref is None:
        ref = out
    d = np.abs(out - ref).max()
    print(
        f"merge={merge:5d}: {n_class:2d} classes, {rows:6d} gather rows "
        f"-> {t*1e3:7.2f} ms/GN (max pose diff {d:.2e})",
        flush=True,
    )
