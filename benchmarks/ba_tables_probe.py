"""Gather-table BA vs segment_sum BA: correctness + device timing at the
config-4 (1k/500) and config-5 (10k/5k) shapes."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu.models import ba, graph_builder


def bench(n_kf, n_lm, iters=5, cg=50, reps=3):
    problem, _, _ = graph_builder.synthetic_ba_problem(n_kf, n_lm, obs_per_kf=8, seed=0)
    tables = ba.build_tables(problem)
    print(
        f"[{n_kf}/{n_lm}] tables: kf_rows {tables.kf_rows.shape} "
        f"lm_sort {tables.lm_sort_rows.shape}", flush=True,
    )
    pj = jax.tree.map(jnp.asarray, problem)

    def timeit(fn):
        out = fn(pj)
        np.asarray(out[0])  # sync
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(pj)
            jax.block_until_ready(out[0])
            best = min(best, time.perf_counter() - t0)
        return best, out

    base = jax.jit(lambda p: ba.solve(p, iters=iters, cg_iters=cg, damping=1e-4))
    tab = jax.jit(
        lambda p: ba.solve(p, iters=iters, cg_iters=cg, damping=1e-4, tables=tables)
    )
    packed, ptables, static = ba.prepare(problem)
    print(f"[{n_kf}/{n_lm}] prepare: {static}, packed N = {packed.obs_kf.shape}",
          flush=True)
    prep = jax.jit(
        lambda p: ba.solve(
            p, iters=iters, cg_iters=cg, damping=1e-4, tables=ptables, **static
        )
    )

    def timeit_packed(fn):
        out = fn(packed)
        np.asarray(out[0])
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(packed)
            jax.block_until_ready(out[0])
            best = min(best, time.perf_counter() - t0)
        return best, out

    t0, out0 = timeit(base)
    t1, out1 = timeit(tab)
    t2, out2 = timeit_packed(prep)
    d_pose = float(jnp.max(jnp.abs(out0[0] - out1[0])))
    d_cost = abs(float(out0[2].final_cost) - float(out1[2].final_cost))
    d_pose2 = float(jnp.max(jnp.abs(out0[0] - out2[0])))
    print(
        f"[{n_kf}/{n_lm}] segsum {iters/t0:7.1f} GN/s | tables {iters/t1:7.1f} GN/s "
        f"({t0/t1:4.1f}x) | packed {iters/t2:7.1f} GN/s ({t0/t2:4.1f}x) | "
        f"pose diff tab {d_pose:.2e} packed {d_pose2:.2e} cost diff {d_cost:.3g}",
        flush=True,
    )


if __name__ == "__main__":
    bench(1000, 500)
    bench(10000, 5000)
