"""Primitive-level timing for the BA matvec at the 10k/5k shape.

Each primitive is applied R times inside ONE jitted lax.scan (chained
through a scalar so nothing is DCE'd) — un-amortized micro timings would
measure the per-dispatch cost, not the primitive."""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, K, L = 80_000, 10_000, 5_000
R = 50
rng = np.random.default_rng(0)
obs_kf = jnp.asarray(np.sort(rng.integers(0, K, N)).astype(np.int32))
obs_lm = jnp.asarray(rng.integers(0, L, N).astype(np.int32))
vals = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
mats = jnp.asarray(rng.normal(size=(N, 3, 3)).astype(np.float32))
vK = jnp.asarray(rng.normal(size=(K, 3)).astype(np.float32))
vL = jnp.asarray(rng.normal(size=(L, 3)).astype(np.float32))

from aruco_slam_tpu.models import ba

kf_rows = jnp.asarray(ba._rows_table(np.asarray(obs_kf), K, N))
lm_full = ba._rows_table(np.asarray(obs_lm), L, N)
lm_rows64 = jnp.asarray(lm_full[:, :64])


def timeit(name, body, reps=5):
    """body(c: scalar) -> array; scan R times chained through the scalar."""

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
    print(f"{name:38s} {best*1e6/R:9.1f} us/op", flush=True)


timeit("noop baseline (scale [N,3])", lambda c: vals * c)
timeit("gather vK[obs_kf] -> [N,3]", lambda c: (vK * c)[obs_kf])
timeit("gather vL[obs_lm] -> [N,3]", lambda c: (vL * c)[obs_lm])
timeit("segsum kf (sorted ids)", lambda c: jax.ops.segment_sum(vals * c, obs_kf, num_segments=K))
timeit("segsum kf sorted-flag", lambda c: jax.ops.segment_sum(vals * c, obs_kf, num_segments=K, indices_are_sorted=True))
timeit("segsum lm (random ids)", lambda c: jax.ops.segment_sum(vals * c, obs_lm, num_segments=L))
timeit("table-sum kf [10k,8]", lambda c: ba._sum_rows(vals * c, kf_rows))
timeit("table-sum lm [5k,64]", lambda c: ba._sum_rows(vals * c, lm_rows64))
timeit("batched 3x3 matvec [N]", lambda c: (mats @ (vals * c)[..., None])[..., 0])
timeit("dense resh sum [K,8,3]->[K,3]", lambda c: jnp.sum((vals * c).reshape(K, 8, 3), axis=1))
timeit("cumsum [N,3]", lambda c: jnp.cumsum(vals * c, axis=0))
timeit("scatter-add .at[].add [N->L]", lambda c: jnp.zeros((L, 3), vals.dtype).at[obs_lm].add(vals * c))
