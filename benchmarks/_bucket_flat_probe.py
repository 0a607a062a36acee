"""Probe: landmark bucket reduction as ONE flat gather + per-class slice
reshape-sums, vs one gather per class (current _seg_sum_lm). If the cost
is per-launch rather than per-row, folding 5-6 gathers into one wins.

Also times the full gn-step with the flat variant monkey-patched in.

NOTE (round 5): predates the two-level (chunk_tab, comb_tab) tuple
entries build_tables now emits for wide classes at the 10k/5k shape —
tuple entries are flattened to their chunk_tab below (the probe then
measures the chunk level only, which carries ~98% of the gathered rows).
"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
L = 5000
N = packed.obs_kf.shape[0]

# flat form of the bucket tables (two-level tuple entries -> chunk level)
tabs_flat = [
    t[0] if isinstance(t, tuple) else t for t in tables.lm_bucket_tabs
]
caps = [int(t.shape[1]) for t in tabs_flat]
sizes = [int(t.shape[0]) for t in tabs_flat]
flat_rows = jnp.concatenate([t.reshape(-1) for t in tabs_flat])
print("classes:", list(zip(sizes, caps)), "flat rows:", flat_rows.shape[0],
      flush=True)


def seg_sum_lm_flat(vals, ids, L_, tabs):
    flat = vals if vals.ndim == 2 else vals.reshape(vals.shape[0], -1)
    padded = jnp.concatenate(
        [flat, jnp.zeros((1, flat.shape[1]), flat.dtype)], axis=0
    )
    g = padded[flat_rows]  # ONE gather [sum(n_c*cap_c), F]
    parts = []
    off = 0
    for n_c, cap in zip(sizes, caps):
        seg = g[off:off + n_c * cap].reshape(n_c, cap, flat.shape[1])
        parts.append(seg.sum(axis=1))
        off += n_c * cap
    out = jnp.concatenate(parts, axis=0)[tables.lm_rank]
    return out.reshape(L_, *vals.shape[1:])


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
print(f"floor {floor*1e3:.2f} ms", flush=True)

# correctness
x = jnp.asarray(np.random.RandomState(0).randn(N, 3).astype(np.float32))
a = np.asarray(ba._seg_sum_lm(x, packed.obs_lm, L, tables))
b = np.asarray(seg_sum_lm_flat(x, packed.obs_lm, L, tables))
print("max diff flat vs class-wise:", np.abs(a - b).max(), flush=True)

# stage-alone timing, chained
R = 20
for name, f in [("class-wise", ba._seg_sum_lm), ("flat", seg_sum_lm_flat)]:
    @jax.jit
    def prog(x0, f=f):
        def step(c, _):
            return jnp.sum(f(x0 * c, packed.obs_lm, L, tables)) * 1e-12 + c * 0.5, None

        return jax.lax.scan(step, jnp.float32(1.0), None, length=R)[0]

    t = (timeit(prog, x) - floor) / R
    print(f"{name:12s} {t*1e6:8.1f} us per [N,3] reduction", flush=True)

# full gn-step with the flat variant patched in
orig = ba._seg_sum_lm
for name, fn in [("class-wise", orig), ("flat", seg_sum_lm_flat)]:
    ba._seg_sum_lm = fn
    f = jax.jit(
        lambda pt: ba.solve(
            pt, iters=2, cg_iters=50, damping=1e-4, tables=tables,
            unroll=True, **static
        )
    )
    t = (timeit(f, packed) - floor) / 2
    print(f"gn-step with {name:10s}: {t*1e3:7.2f} ms/GN", flush=True)
ba._seg_sum_lm = orig
