"""Probe: where the CG iteration body spends its non-matvec time at the
config-5 shape, and why a 5-GN-iter solve costs more per GN than a
1-GN-iter solve (ba_stage_inventory.py).

Legs:
  pcg-full        _pcg as shipped (block-Jacobi precond), cg=50
  pcg-noprecond   identity preconditioner
  pcg-matvec-only 50 chained bare matvecs (no dots/axpys/precond)
  solve-iters1/2/5  full solve at different GN trip counts (per-GN ms)
"""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu.models import ba, graph_builder

K, L = 10000, 5000
problem, _, _ = graph_builder.synthetic_ba_problem(K, L, obs_per_kf=8, seed=0)
packed, tables, static = ba.prepare(problem)
O, chain = static["kf_width"], static["odo_chain"]

lin = jax.jit(
    lambda: ba._linearize(
        packed, packed.poses, packed.landmarks, 1e-4, tables, O, chain
    )
)()
np.asarray(lin["bp"])
rhs = lin["bp"]


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

pcg_full = jax.jit(
    lambda b: ba._pcg(lin, packed, b, 50, tables=tables, kf_width=O,
                      odo_chain=chain)[0]
)


def _pcg_noprecond(b):
    x0 = jnp.zeros_like(b)

    def body(carry, _):
        x, r, p, rz = carry
        Sp = ba._schur_matvec(lin, packed, p, tables, O, chain)
        denom = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = x + alpha * p
        r = r - alpha * Sp
        rz_new = jnp.sum(r * r)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = r + beta * p
        return (x, r, p, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(
        body, (x0, b, b, jnp.sum(b * b)), None, length=50
    )
    return x


pcg_nop = jax.jit(_pcg_noprecond)


def _matvec_only(b):
    def body(v, _):
        return ba._schur_matvec(lin, packed, v, tables, O, chain) * 1e-3 + v, None

    return jax.lax.scan(body, b, None, length=50)[0]


mv_only = jax.jit(_matvec_only)

for name, f in [("pcg-full(cg50)", pcg_full), ("pcg-noprecond", pcg_nop),
                ("matvec-only x50", mv_only)]:
    t = timeit(f, rhs) - floor
    print(f"{name:18s} {t*1e3:8.2f} ms ({t/50*1e6:6.1f} us/iter)",
          flush=True)

for iters in (1, 2, 5):
    f = jax.jit(
        lambda c, it=iters: ba.solve(
            packed._replace(poses=packed.poses * c), iters=it, cg_iters=50,
            damping=1e-4, tables=tables, kf_width=O, odo_chain=chain,
        )[2].final_cost[None]
    )
    t = timeit(f, jnp.float32(1.0)) - floor
    print(f"solve iters={iters}: {t*1e3:8.2f} ms total, "
          f"{t/iters*1e3:7.2f} ms/GN", flush=True)
