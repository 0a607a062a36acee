"""Isolate the landmark segmented-scan cost at 10k/5k shapes: AoS [N,F]
scan vs lanes-internal [F,N] scan vs combined widths."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp, numpy as np
from aruco_slam_tpu.models import ba, graph_builder

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
N = packed.obs_z.shape[0]
L = 5000
rng = np.random.default_rng(0)

def timeit(name, body, F, reps=5, R=20):
    x0 = jnp.asarray(rng.normal(size=(N, F)).astype(np.float32))
    def f(c):
        def step(c, _):
            out = body(x0 * c)
            return jnp.sum(out) * 1e-12 + c * 0.5, None
        return jax.lax.scan(step, c, None, length=R)[0]
    g = jax.jit(f)
    out = g(jnp.float32(1.0)); np.asarray(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = g(jnp.float32(1.0)); jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:34s} {(best*1e6)/R:9.1f} us/call (incl ~{30e3/R:.0f}us floor share)", flush=True)

def aos(vals):
    return ba._seg_sum_lm(vals, packed.obs_lm, L, tables)

def lanes(vals):
    rows = [vals[:, i] for i in range(vals.shape[1])]
    out = ba._seg_sum_lm_soa(rows, tables, L)
    return jnp.stack(out, axis=-1)

for F in (3, 9, 12):
    timeit(f"AoS scan [N,{F}]", aos, F)
    timeit(f"lanes scan [{F},N]", lanes, F)
