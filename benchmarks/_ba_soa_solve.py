"""SoA BA solve throughput at config4 (1k/500) and config5 (10k/5k)."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp, numpy as np
from aruco_slam_tpu.models import ba, graph_builder

def bench(n_kf, n_lm, iters=10, cg=50, reps=5):
    problem, _, _ = graph_builder.synthetic_ba_problem(n_kf, n_lm, obs_per_kf=8, seed=0)
    packed, tables, static = ba.prepare(problem)
    for soa in (False, True):
        st = dict(static); st["soa"] = soa
        solve = jax.jit(lambda p, t: ba.solve(p, iters=iters, cg_iters=cg, damping=1e-4, tables=t, **st))
        out = solve(packed, tables)
        np.asarray(out[0])
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = solve(packed, tables)
            jax.block_until_ready(out[0])
            best = min(best, time.perf_counter() - t0)
        cr = float(out[2].initial_cost / max(float(out[2].final_cost), 1e-9))
        print(f"{n_kf}/{n_lm} soa={soa}: {iters/best:7.2f} GN/s  ({1e3*best:.1f} ms, cost_red {cr:.3g})", flush=True)

bench(1000, 500)
bench(10000, 5000)
