"""True per-op CCL costs: iterate each op K times inside one jitted program
(single dispatch) to remove the per-dispatch cost from the number."""
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
K = 20
rng = np.random.default_rng(0)
fg = jnp.asarray(rng.random((B, H, W)) > 0.7)
lab0 = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32).reshape(H, W), (B, H, W))
lab0 = jnp.where(fg, lab0 - (lab0 // 7) * 3, lab0)
jax.block_until_ready((fg, lab0))

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
                sh = sh.at[:, 0].set(big)
            best = jnp.minimum(best, sh)
    return jnp.where(m, jnp.minimum(lab, best), lab)


def iterate(op):
    def run(lab, m):
        return jax.lax.fori_loop(0, K, lambda _, l: op(l, m), lab)
    return jax.jit(jax.vmap(run))


def timeit(fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    return (time.time() - t0) / reps


cases = {
    "neighbor_min(9roll)": neighbor_min,
    "row seg-scan": lambda l, m: det._seg_min_scan(l, m, big, 1, False),
    "col seg-scan": lambda l, m: det._seg_min_scan(l, m, big, 0, False),
    "full 307k jump": lambda l, m: l.reshape(-1)[l.reshape(-1)].reshape(H, W),
    "full round(nb+4scan)": lambda l, m: det._seg_min_scan(
        det._seg_min_scan(
            det._seg_min_scan(
                det._seg_min_scan(neighbor_min(l, m), m, big, 1, False),
                m, big, 1, True),
            m, big, 0, False),
        m, big, 0, True),
}
for name, op in cases.items():
    t = timeit(iterate(op), lab0, fg)
    print(f"{name:22s}: {1e6*t/(B*K):9.1f} us/frame/op", flush=True)
