"""Ablate terms of the packed Schur matvec at 10k/5k to locate its cost."""

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
O = static["kf_width"]
K, L = N_KF, N_LM
lin = jax.jit(
    lambda p: ba._linearize(p, p.poses, p.landmarks, 1e-4, tables, O, True)
)(packed)
jax.block_until_ready(lin["Apl"])
print("lm_rows", tables.lm_rows.shape,
      "overflow", None if tables.lm_over_rows is None else tables.lm_over_rows.shape,
      flush=True)
v0 = jnp.ones((K, 3), jnp.float32)


def run(name, body, reps=5):
    def scan_fn(v):
        def step(c, _):
            out = body(c)
            return out / jnp.maximum(jnp.linalg.norm(out), 1e-9), None
        return jax.lax.scan(step, v, None, length=50)[0]

    f = jax.jit(scan_fn)
    out = f(v0)
    np.asarray(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(v0)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:46s} {best*1e3/50:8.3f} ms/matvec", flush=True)


Apl = lin["Apl"]
AplT = jnp.swapaxes(Apl, -1, -2)
Hll_inv = lin["Hll_inv"]
Hij = lin["Hij"]
HijT = jnp.swapaxes(Hij, -1, -2)
Hpp = lin["Hpp_diag"]


def full(v):
    return ba._schur_matvec(lin, packed, v, tables, O, True)


def no_odo(v):
    out = (Hpp @ v[..., None])[..., 0]
    v_obs = jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (AplT @ v_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    u = (Hll_inv @ t_lm[..., None])[..., 0]
    back = (Apl @ u[packed.obs_lm][..., None])[..., 0]
    return out - jnp.sum(back.reshape(K, O, 3), axis=1)


def no_lmsum(v):
    out = (Hpp @ v[..., None])[..., 0]
    v_obs = jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (AplT @ v_obs[..., None])[..., 0]
    t_lm = jnp.sum(t.reshape(L, -1, 3), axis=1)  # stand-in dense reduce
    u = (Hll_inv @ t_lm[..., None])[..., 0]
    back = (Apl @ u[packed.obs_lm][..., None])[..., 0]
    return out - jnp.sum(back.reshape(K, O, 3), axis=1)


def no_ugather(v):
    out = (Hpp @ v[..., None])[..., 0]
    v_obs = jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (AplT @ v_obs[..., None])[..., 0]
    t_lm = ba._seg_sum_lm(t, packed.obs_lm, L, tables)
    u = (Hll_inv @ t_lm[..., None])[..., 0]
    back = (Apl @ (t * jnp.sum(u) * 1e-9)[..., None])[..., 0]
    return out - jnp.sum(back.reshape(K, O, 3), axis=1)


def only_matmuls(v):
    out = (Hpp @ v[..., None])[..., 0]
    v_obs = jnp.broadcast_to(v[:, None, :], (K, O, 3)).reshape(-1, 3)
    t = (AplT @ v_obs[..., None])[..., 0]
    back = (Apl @ t[..., None])[..., 0]
    return out - jnp.sum(back.reshape(K, O, 3), axis=1)


def hpp_only(v):
    return (Hpp @ v[..., None])[..., 0]


run("full matvec", full)
run("no odo coupling", no_odo)
run("no lm table-sum (dense stand-in)", no_lmsum)
run("no u[obs_lm] gather", no_ugather)
run("matmuls+kf-sum only (no lm at all)", only_matmuls)
run("Hpp diag only", hpp_only)
