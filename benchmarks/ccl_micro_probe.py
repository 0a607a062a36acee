"""Micro-costs of CCL building blocks on the real chip, batch 8:
scan round vs full-image pointer jump vs sparse (strided) jump.
Informs the CCL redesign (VERDICT round-2 item 1)."""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aruco_slam_tpu.ops import detector as det

B, H, W = 8, 480, 640
N = H * W
rng = np.random.default_rng(0)
fg = jnp.asarray(rng.random((B, H, W)) > 0.7)
lab0 = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32).reshape(H, W), (B, H, W))
lab0 = jnp.where(fg, lab0 - (lab0 // 7) * 3, lab0)  # chained-ish labels
jax.block_until_ready((fg, lab0))


def timeit(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.time() - t0) / reps


big = jnp.int32(N)


def neighbor_min(lab, m):
    lab_m = jnp.where(m, lab, big)
    best = lab_m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sh = jnp.roll(lab_m, (dy, dx), axis=(0, 1))
            if dy == -1:
                sh = sh.at[-1, :].set(big)
            if dy == 1:
                sh = sh.at[0, :].set(big)
            if dx == -1:
                sh = sh.at[:, -1].set(big)
            if dx == 1:
                sh = sh.at[:, 1].set(big)
            best = jnp.minimum(best, sh)
    return jnp.where(m, jnp.minimum(lab, best), lab)


f_nb = jax.jit(jax.vmap(neighbor_min))
print(f"neighbor_min (9 rolls) : {1e3*timeit(f_nb, lab0, fg)/B:8.3f} ms/frame", flush=True)

f_scan1 = jax.jit(jax.vmap(lambda l, m: det._seg_min_scan(l, m, big, 1, False)))
print(f"row seg-scan           : {1e3*timeit(f_scan1, lab0, fg)/B:8.3f} ms/frame", flush=True)

f_scan0 = jax.jit(jax.vmap(lambda l, m: det._seg_min_scan(l, m, big, 0, False)))
print(f"col seg-scan           : {1e3*timeit(f_scan0, lab0, fg)/B:8.3f} ms/frame", flush=True)


def full_jump(lab):
    flat = lab.reshape(-1)
    return flat[flat].reshape(H, W)


f_jump = jax.jit(jax.vmap(full_jump))
print(f"full 307k jump (1x)    : {1e3*timeit(f_jump, lab0)/B:8.3f} ms/frame", flush=True)

sparse = (
    (jnp.arange(0, H, 4, dtype=jnp.int32)[:, None] * W
     + jnp.arange(0, W, 4, dtype=jnp.int32)[None, :]).reshape(-1)
)


def sparse_jump(lab):
    flat = lab.reshape(-1)
    v = flat[flat[sparse]]
    v = flat[v]
    flat = flat.at[sparse].min(v)
    return flat.reshape(H, W)


f_sjump = jax.jit(jax.vmap(sparse_jump))
print(f"sparse 19k double-jump : {1e3*timeit(f_sjump, lab0)/B:8.3f} ms/frame", flush=True)

for rounds in (4, 8, 16):
    f_ccl = jax.jit(jax.vmap(lambda m, r=rounds: det.label_components(m, r)))
    print(f"scan CCL rounds={rounds:2d}     : {1e3*timeit(f_ccl, fg, reps=3)/B:8.3f} ms/frame", flush=True)
