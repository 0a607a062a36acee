"""Measure config4 (1k/500) and config5 single-device (10k/5k) GN/s with
the degree-class bucketed landmark reduction (round 3)."""
import os, sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run_all

print("config4:", run_all.config4_ba())
print("config5 10k/5k:")
import time
import jax.numpy as jnp
import numpy as np
from aruco_slam_tpu.models import ba, graph_builder

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
solve = jax.jit(
    lambda pt: ba.solve(
        pt[0], iters=5, cg_iters=50, damping=1e-4, tables=pt[1], **static
    )
)
dt, out = run_all.timeit(solve, [(packed, tables)], reps=3)
stats = out[2]
print("  %.2f GN/s (%.1f ms, cost_red %.0f)"
      % (5 / dt, dt * 1e3, float(stats.initial_cost / max(float(stats.final_cost), 1e-9))))
