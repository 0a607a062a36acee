"""Itemize ONE CG iteration of the config-5 Schur matvec
(10k kf / 5k lm / 80k obs) term by term, against the per-row gather
floor. Each term runs 50x chained in one jitted program (dependence
via folding a scalar back into the carry) so the per-dispatch launch
latency cancels; per-call ms = (t - t_bare) / 50.

Terms (matching models/ba._schur_matvec):
  full         the shipped matvec
  hpp_odo      Hpp_diag @ v + odometry-chain coupling
  aplT_mm      broadcast v -> v_obs, Apl^T @ v_obs           (no gather)
  gather_lm    _seg_sum_lm over a fixed [N, 3]               (gather #1)
  hll_apply    Hll_inv @ t_lm
  gather_obs   u[obs_lm]                                      (gather #2)
  apl_mm       Apl @ u_obs (fixed u_obs)                      (no gather)
  kf_sum       reshape-sum of a fixed back [N, 3]
  precond_dots block-Jacobi apply + the CG dots/axpys
"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder
from aruco_slam_tpu.ops import linalg as small_linalg

K, L = 10000, 5000
problem, _, _ = graph_builder.synthetic_ba_problem(K, L, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
O, chain = static["kf_width"], static["odo_chain"]
N = K * O

lin = jax.jit(
    lambda p: ba._linearize(
        p, p.poses, p.landmarks, 1e-4, tables, O, chain
    )
)(packed)
jax.block_until_ready(lin["Apl"])
v0 = jnp.ones((K, 3), jnp.float32)
t_fix = jnp.ones((N, 3), jnp.float32)
tlm_fix = jnp.ones((L, 3), jnp.float32)
u_fix = jnp.ones((L, 3), jnp.float32)
uobs_fix = jnp.ones((N, 3), jnp.float32)
back_fix = jnp.ones((N, 3), jnp.float32)
Minv = jax.jit(lambda h: small_linalg.inv3x3(h))(lin["Hpp_diag"])
jax.block_until_ready(Minv)

REPS = 50


def run(name, body, reps=5):
    def scan_fn(v):
        def step(c, _):
            s = body(c)
            return v0 + 1e-30 * s, None

        return jax.lax.scan(step, v, None, length=REPS)[0][0, 0]

    f = jax.jit(scan_fn)
    out = f(v0)
    float(np.asarray(out))  # sync
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(v0)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return name, best * 1e3 / REPS


def fold(x):
    return jnp.sum(x)


bodies = {
    "bare": lambda v: jnp.sum(v),
    "full": lambda v: fold(
        ba._schur_matvec(lin, packed, v, tables, O, chain)
    ),
    "hpp_odo": lambda v: fold(
        (lin["Hpp_diag"] @ v[..., None])[..., 0]
        + ba._chain_pad_i((lin["Hij"] @ v[1:][..., None])[..., 0])
        + ba._chain_pad_j(
            (jnp.swapaxes(lin["Hij"], -1, -2) @ v[:-1][..., None])[..., 0]
        )
    ),
    "aplT_mm": lambda v: fold(
        (
            jnp.swapaxes(lin["Apl"], -1, -2)
            @ jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)[
                ..., None
            ]
        )[..., 0]
    ),
    "gather_lm": lambda v: fold(
        ba._seg_sum_lm(t_fix + 1e-30 * v[0, 0], packed.obs_lm, L, tables)
    ),
    "hll_apply": lambda v: fold(
        (lin["Hll_inv"] @ (tlm_fix + 1e-30 * v[0, 0])[..., None])[..., 0]
    ),
    "gather_obs": lambda v: fold(
        (u_fix + 1e-30 * v[0, 0])[packed.obs_lm]
    ),
    "apl_mm": lambda v: fold(
        (lin["Apl"] @ (uobs_fix + 1e-30 * v[0, 0])[..., None])[..., 0]
    ),
    "gather_obs+apl_mm": lambda v: fold(
        (lin["Apl"] @ (u_fix + 1e-30 * v[0, 0])[packed.obs_lm][..., None])[
            ..., 0
        ]
    ),
    "kf_sum": lambda v: fold(
        jnp.sum((back_fix + 1e-30 * v[0, 0]).reshape(K, O, 3), axis=1)
    ),
    "precond_dots": lambda v: fold(
        (Minv @ v[..., None])[..., 0] * v + jnp.sum(v * v) * v
    ),
}

t_bare = None
for name, body in bodies.items():
    n, ms = run(name, body)
    if name == "bare":
        t_bare = ms
        print(f"{n:22s} {ms:8.4f} ms", flush=True)
    else:
        print(f"{n:22s} {ms:8.4f} ms  (net {ms - t_bare:8.4f})", flush=True)
