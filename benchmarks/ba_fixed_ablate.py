"""Ablate the per-GN fixed part (cg_iters=0) of the packed 10k/5k solve:
linearize / rhs / back-substitution / cost evaluation."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu.models import ba, graph_builder
from aruco_slam_tpu.ops import geometry

problem, _, _ = graph_builder.synthetic_ba_problem(10000, 5000, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
O, chain = static["kf_width"], static["odo_chain"]
K, L = 10000, 5000


def timeit(name, f, arg, reps=5):
    out = f(arg)
    np.asarray(jax.tree.leaves(out)[0])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(arg)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        best = min(best, time.perf_counter() - t0)
    print(f"{name:44s} {best*1e3:9.2f} ms (x10 incl ~30ms floor)", flush=True)


def scan10(body):
    def f(c0):
        def step(c, _):
            out = body(c)
            return jnp.sum(out) * 1e-12 + c * 0.5, None
        return jax.lax.scan(step, c0, None, length=10)[0]
    return jax.jit(f)


prior_pose = packed.poses[0]


def lin_only(c):
    lin = ba._linearize(packed, packed.poses * c, packed.landmarks, 1e-4,
                        tables, O, chain)
    return lin["bp"]


def lin_rhs(c):
    lin = ba._linearize(packed, packed.poses * c, packed.landmarks, 1e-4,
                        tables, O, chain)
    r0 = prior_pose - packed.poses[0] * c
    bp = lin["bp"].at[0].add(packed.prior_w @ r0)
    u = (lin["Hll_inv"] @ lin["bl"][..., None])[..., 0]
    back = (lin["Apl"] @ u[packed.obs_lm][..., None])[..., 0]
    bs = bp - ba._kf_sum(back, packed.obs_kf, K, None, O)
    return bs


def lin_rhs_backsub(c):
    lin = ba._linearize(packed, packed.poses * c, packed.landmarks, 1e-4,
                        tables, O, chain)
    bs = lin_rhs(c)  # recompute path is fused by XLA anyway? keep simple
    dp = bs * 1e-3
    dp_obs = jnp.broadcast_to(dp[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (jnp.swapaxes(lin["Apl"], -1, -2) @ dp_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    dl = (lin["Hll_inv"] @ (lin["bl"] - t_lm)[..., None])[..., 0]
    return dl


def cost_only(c):
    return ba.cost(packed, packed.poses * c, packed.landmarks, prior_pose)[None]


timeit("linearize only", scan10(lin_only), jnp.float32(1.0))
timeit("linearize + reduced rhs", scan10(lin_rhs), jnp.float32(1.0))
timeit("linearize + rhs + backsub", scan10(lin_rhs_backsub), jnp.float32(1.0))
timeit("cost() only", scan10(cost_only), jnp.float32(1.0))
