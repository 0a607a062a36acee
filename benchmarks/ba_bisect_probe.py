"""Bisect the 10k/5k GN step: linearize vs CG loop vs standalone matvec."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu.models import ba, graph_builder

N_KF, N_LM = 10000, 5000
problem, _, _ = graph_builder.synthetic_ba_problem(N_KF, N_LM, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
kf_width, odo_chain = static["kf_width"], static["odo_chain"]


def timeit(name, f, *args, reps=5):
    out = f(*args)
    np.asarray(jax.tree.leaves(out)[0])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        best = min(best, time.perf_counter() - t0)
    print(f"{name:44s} {best*1e3:9.2f} ms", flush=True)
    return out


for n_cg in (0, 25, 50):
    f = jax.jit(
        lambda p, n=n_cg: ba.solve(
            p, iters=2, cg_iters=n, damping=1e-4, tables=tables, **static
        )
    )
    timeit(f"solve packed iters=2 cg={n_cg}", f, packed)

# standalone matvec scan (50 applications on fixed lin)
lin = jax.jit(
    lambda p: ba._linearize(p, p.poses, p.landmarks, 1e-4, tables, kf_width, odo_chain)
)(packed)
jax.block_until_ready(lin["Apl"])
v0 = jnp.ones((N_KF, 3), jnp.float32)


def mv_scan(v):
    def body(c, _):
        out = ba._schur_matvec(lin, packed, c, tables, kf_width, odo_chain)
        return out / jnp.maximum(jnp.linalg.norm(out), 1e-9), None

    return jax.lax.scan(body, v, None, length=50)[0]


timeit("matvec x50 (packed, fixed lin)", jax.jit(mv_scan), v0)


def lin_scan(c0):
    def body(c, _):
        lin2 = ba._linearize(
            packed, packed.poses * c, packed.landmarks, 1e-4, tables,
            kf_width, odo_chain,
        )
        return jnp.sum(lin2["bp"]) * 1e-12 + 1.0, None

    return jax.lax.scan(body, c0, None, length=10)[0]


timeit("linearize x10 (packed)", jax.jit(lin_scan), jnp.float32(1.0))
