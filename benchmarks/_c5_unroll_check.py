"""Clean min-of-5 comparison of solve variants at 10k/5k, iters=5 cg=50:
scan vs unroll, full outputs fetched like run_all's config5 leg."""

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
    return min(ts), ts


floor, _ = timeit(null_prog, jnp.zeros((4, 4), jnp.float32))
print(f"floor {floor*1e3:.2f} ms", flush=True)

for unroll in (False, True):
    f = jax.jit(
        lambda pt, u=unroll: ba.solve(
            pt[0], iters=5, cg_iters=50, damping=1e-4, tables=pt[1],
            unroll=u, **static
        )
    )
    t, ts = timeit(f, (packed, tables))
    print(
        f"unroll={unroll}: min {t*1e3:7.1f} ms  all "
        f"{[round(x*1e3,1) for x in ts]}  -> {5/t:.2f} GN/s incl floor, "
        f"{(t - floor)/5*1e3:.2f} ms/GN net",
        flush=True,
    )
