"""Compare BA solver variants on the saved config-2 problem (CPU)."""
import pickle
import sys
import time

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu.models import ba

with open("/tmp/config2_problem.pkl", "rb") as f:
    d = pickle.load(f)
problem = jax.tree.map(jnp.asarray, d["problem"])
true_lms = d["true_lms"]

def run(iters, cg, adaptive, deflate, damping=1e-4):
    t0 = time.time()
    p, l, s = jax.jit(
        lambda pr: ba.solve(pr, iters=iters, cg_iters=cg, damping=damping,
                            adaptive=adaptive, deflate_gauge=deflate)
    )(problem)
    jax.block_until_ready(p)
    dt = time.time() - t0
    err = float(np.mean(np.linalg.norm(np.asarray(l)[:, :2] - true_lms[:, :2], axis=1)))
    print(f"iters={iters} cg={cg} adaptive={int(adaptive)} deflate={int(deflate)}: "
          f"map_err={err:.4f} cost {float(s.initial_cost):.2f}->{float(s.final_cost):.4f} "
          f"wall={dt:.1f}s (incl compile)")

for it, cg in ((12, 120), (60, 400)):
    run(it, cg, False, False)
for it, cg in ((6, 60), (12, 120), (20, 200), (60, 400)):
    run(it, cg, True, True)
