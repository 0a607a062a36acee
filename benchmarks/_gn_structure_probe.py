"""Probe: does a CG iteration cost more inside ba.solve's GN scan than
when the CG scan is the top-level program, and why?

Hypotheses: (a) the nested scan (GN scan body containing the CG scan)
pessimizes layouts of the scan-internal lin dict; (b) something else in
the gn_step body. Legs:

  gn-step-jit      one gn_step jitted directly (no outer GN scan), cg=50
  solve-scan       ba.solve as shipped, iters=2 (per-GN)
  solve-unrolled   same math, Python for-loop over GN iters (no outer scan)
  matvec internals hpp-part / t+bucket-sum / u-gather+back halves
  bucket-width     [N,3] vs [N,8]-padded rows through the bucket tables
"""

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
N = K * O
prior_pose = packed.poses[0]

lin = jax.jit(
    lambda: ba._linearize(
        packed, packed.poses, packed.landmarks, 1e-4, tables, O, chain
    )
)()
np.asarray(lin["bp"])


@jax.jit
def null_prog(x):
    return x + 1.0


def timeit(prog, *args, reps=5):
    out = prog(*args)
    np.asarray(jax.tree.leaves(out)[0]).ravel()[:1]
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(prog(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


floor = timeit(null_prog, jnp.zeros((4, 4), jnp.float32))
print(f"floor {floor*1e3:.2f} ms", flush=True)


def gn_step(poses, landmarks, lam):
    lin_ = ba._linearize(packed, poses, landmarks, lam, tables, O, chain)
    r0 = prior_pose - poses[0]
    r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
    bp = lin_["bp"].at[0].add(packed.prior_w @ r0)
    u = (lin_["Hll_inv"] @ lin_["bl"][..., None])[..., 0]
    back = (lin_["Apl"] @ u[packed.obs_lm][..., None])[..., 0]
    bs = bp - ba._kf_sum(back, packed.obs_kf, K, None, O)
    dp, _ = ba._pcg(lin_, packed, bs, 50, tables=tables, kf_width=O,
                    odo_chain=chain)
    dp_obs = jnp.broadcast_to(dp[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (jnp.swapaxes(lin_["Apl"], -1, -2) @ dp_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    dl = (lin_["Hll_inv"] @ (lin_["bl"] - t_lm)[..., None])[..., 0]
    new_poses = poses + dp
    new_poses = new_poses.at[:, 2].set(geometry.wrap_angle(new_poses[:, 2]))
    new_landmarks = landmarks + dl
    new_landmarks = new_landmarks.at[:, 2].set(
        geometry.wrap_angle(new_landmarks[:, 2])
    )
    return new_poses, new_landmarks


one_step = jax.jit(
    lambda c: gn_step(packed.poses * c, packed.landmarks,
                      jnp.float32(1e-4))[0]
)
t = timeit(one_step, jnp.float32(1.0)) - floor
print(f"gn-step-jit (cg=50, no outer scan): {t*1e3:8.2f} ms", flush=True)


@jax.jit
def solve_unrolled(c):
    poses, landmarks = packed.poses * c, packed.landmarks
    for _ in range(2):
        poses, landmarks = gn_step(poses, landmarks, jnp.float32(1e-4))
    return poses


t = (timeit(solve_unrolled, jnp.float32(1.0)) - floor) / 2
print(f"solve-unrolled (2 GN): {t*1e3:8.2f} ms/GN", flush=True)

t = (
    timeit(
        jax.jit(
            lambda c: ba.solve(
                packed._replace(poses=packed.poses * c), iters=2,
                cg_iters=50, damping=1e-4, tables=tables, kf_width=O,
                odo_chain=chain,
            )[2].final_cost[None]
        ),
        jnp.float32(1.0),
    )
    - floor
) / 2
print(f"solve-scan (2 GN): {t*1e3:8.2f} ms/GN", flush=True)

# ---- matvec internals (top-level chained scans over lin as inputs) ----
R = 20


def chain_vec(f):
    @jax.jit
    def prog(v0):
        def step(v, _):
            return f(v) * 1e-3 + v, None

        return jax.lax.scan(step, v0, None, length=R)[0]

    return prog


def hpp_part(v):
    out = (lin["Hpp_diag"] @ v[..., None])[..., 0]
    ci = (lin["Hij"] @ v[1:][..., None])[..., 0]
    cj = (jnp.swapaxes(lin["Hij"], -1, -2) @ v[:-1][..., None])[..., 0]
    return out + ba._chain_pad_i(ci) + ba._chain_pad_j(cj)


def t_bucket_half(v):
    v_obs = jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (jnp.swapaxes(lin["Apl"], -1, -2) @ v_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    u = (lin["Hll_inv"] @ t_lm[..., None])[..., 0]
    return jnp.concatenate([u, jnp.zeros((K - L, 3), u.dtype)], axis=0)


def u_back_half(u_like):
    u = u_like[:L]
    back = (lin["Apl"] @ u[packed.obs_lm][..., None])[..., 0]
    return ba._kf_sum(back, packed.obs_kf, K, None, O)


v0 = jnp.ones((K, 3), jnp.float32)
for name, f in [("hpp-part", hpp_part), ("t+bucket+u half", t_bucket_half),
                ("u-gather+back half", u_back_half)]:
    t = (timeit(chain_vec(f), v0) - floor) / R
    print(f"{name:20s} {t*1e6:8.1f} us", flush=True)

# ---- bucket gather row width ----
t3 = jnp.ones((N, 3), jnp.float32)
t8 = jnp.ones((N, 8), jnp.float32)


def bucket3(x):
    return ba._seg_sum_lm(x, packed.obs_lm, L, tables)


def bucket8(x):
    padded = jnp.concatenate([x, jnp.zeros((1, 8), x.dtype)], axis=0)
    parts = [padded[tb].sum(axis=1) for tb in tables.lm_bucket_tabs]
    return jnp.concatenate(parts, axis=0)[tables.lm_rank]


for name, f, x in [("bucket [N,3]", bucket3, t3), ("bucket [N,8]", bucket8, t8)]:
    @jax.jit
    def prog(x0, f=f):
        def step(c, _):
            return jnp.sum(f(x0 * c)) * 1e-12 + c * 0.5, None

        return jax.lax.scan(step, jnp.float32(1.0), None, length=R)[0]

    t = (timeit(prog, x) - floor) / R
    print(f"{name:20s} {t*1e6:8.1f} us", flush=True)
