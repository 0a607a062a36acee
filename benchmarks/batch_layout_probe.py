"""Leading-batch tiny matmuls vs trailing-batch elementwise formulation
for the EKF update's core ops at batch 64, N=99 — measured inside one
jitted scan (dispatch floor subtracted via the R-scaling)."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, N = 64, 99
rng = np.random.default_rng(0)
S_lead = jnp.asarray(rng.normal(size=(B, N, N)).astype(np.float32))
G_lead = jnp.asarray(rng.normal(size=(B, 3, N)).astype(np.float32))
K_lead = jnp.asarray(rng.normal(size=(B, N, 3)).astype(np.float32))
S_trail = jnp.asarray(np.moveaxis(np.asarray(S_lead), 0, -1).copy())
G_trail = jnp.asarray(np.moveaxis(np.asarray(G_lead), 0, -1).copy())
K_trail = jnp.asarray(np.moveaxis(np.asarray(K_lead), 0, -1).copy())


def timeit(name, body, reps=5, R=50):
    def step(c, _):
        out = body(c)
        return jnp.sum(out) * 1e-12 + c * 0.5, None

    f = jax.jit(lambda c0: jax.lax.scan(step, c0, None, length=R)[0])
    out = f(jnp.float32(1.0))
    np.asarray(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(jnp.float32(1.0))
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:48s} {best*1e6/R:9.1f} us/op (incl ~610us floor/R)", flush=True)


# B = G @ S : the gain/innovation products
timeit("lead  einsum bik,bkj->bij [64,3,99]@[64,99,99]",
       lambda c: jnp.einsum("bik,bkj->bij", G_lead * c, S_lead))
timeit("trail einsum ikb,kjb->ijb",
       lambda c: jnp.einsum("ikb,kjb->ijb", G_trail * c, S_trail))
timeit("trail explicit mul+sum",
       lambda c: jnp.sum((G_trail * c)[:, :, None, :] * S_trail[None], axis=1))

# rank-3 covariance update S - K @ (G S)
timeit("lead  rank3: S - K@(G@S)",
       lambda c: S_lead - K_lead @ jnp.einsum("bik,bkj->bij", G_lead * c, S_lead))
def trail_rank3(c):
    Bt = jnp.sum((G_trail * c)[:, :, None, :] * S_trail[None], axis=1)  # [3,N,b]
    KB = jnp.sum(K_trail[:, :, None, :] * Bt[None], axis=1)  # [N,N,b]
    return S_trail - KB


timeit("trail rank3 explicit", trail_rank3)
