"""Probe: does materializing the linearization dict behind an
optimization_barrier before the CG loop recover the standalone-pcg CG
iteration cost (cheaper with the lin dict as jit inputs than built
in-program)?"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder
from aruco_slam_tpu.ops import geometry

K, L = 10000, 5000
problem, _, _ = graph_builder.synthetic_ba_problem(K, L, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
O, chain = static["kf_width"], static["odo_chain"]
prior_pose = packed.poses[0]


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


def gn_step(poses, landmarks, barrier):
    lin = ba._linearize(
        packed, poses, landmarks, 1e-4, tables, O, chain, prior_pose
    )
    if barrier:
        lin = jax.lax.optimization_barrier(lin)
    r0 = prior_pose - poses[0]
    r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
    bp = lin["bp"].at[0].add(packed.prior_w @ r0)
    u = (lin["Hll_inv"] @ lin["bl"][..., None])[..., 0]
    back = (lin["Apl"] @ u[packed.obs_lm][..., None])[..., 0]
    bs = bp - ba._kf_sum(back, packed.obs_kf, K, None, O)
    dp, _ = ba._pcg(lin, packed, bs, 50, tables=tables, kf_width=O,
                    odo_chain=chain)
    dp_obs = jnp.broadcast_to(dp[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (jnp.swapaxes(lin["Apl"], -1, -2) @ dp_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    dl = (lin["Hll_inv"] @ (lin["bl"] - t_lm)[..., None])[..., 0]
    return poses + dp, landmarks + dl


for barrier in (False, True):
    f = jax.jit(
        lambda c, b=barrier: gn_step(
            packed.poses * c, packed.landmarks, b
        )[0]
    )
    t = timeit(f, jnp.float32(1.0)) - floor
    print(f"gn-step barrier={barrier}: {t*1e3:7.2f} ms", flush=True)
