"""Psum chain WITH compute between collectives: is the per-psum boundary
cost payload/latency (as a bare psum microbenchmark sees it) or
rendezvous-under-compute?"""
import os, subprocess, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

def worker(pid, n_proc, msize):
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={2 // n_proc}"
    import jax
    jax.config.update("jax_platforms", "cpu")
    if n_proc > 1:
        jax.distributed.initialize("localhost:12405", n_proc, pid)
    from functools import partial
    import jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()), ("x",))
    N = 30
    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(), P("x")), out_specs=P(), check_rep=False)
    def chain(x, m):
        def body(c, _):
            mm = m @ m  # local compute between collectives
            c = c + jax.lax.psum(c, "x") * 1e-9 + mm[0, 0, 0] * 1e-20
            return c, None
        c, _ = jax.lax.scan(body, x, None, length=N)
        return c
    x = jnp.ones((10240, 3), jnp.float32)
    m = jnp.ones((2, msize, msize), jnp.float32)  # sharded: 1 matrix per device... 2 total
    y = chain(x, m); jax.block_until_ready(y)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x, m))
        best = min(best, time.perf_counter() - t0)
    if pid == 0:
        print(f"TOT_MS {1e3*best/N:.2f}", flush=True)
    if n_proc > 1:
        jax.distributed.shutdown()

def run(n_proc, msize):
    procs = [subprocess.Popen(
        [sys.executable, __file__],
        env={**os.environ, "W": str(i), "NP": str(n_proc), "MS": str(msize)},
        stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
        stderr=subprocess.STDOUT, text=True) for i in range(n_proc)]
    txt, _ = procs[0].communicate(timeout=300)
    for p in procs[1:]:
        p.wait(timeout=60)
    line = [l for l in txt.splitlines() if l.startswith("TOT_MS")]
    val = float(line[0].split()[1]) if line else None
    print(f"{n_proc}proc msize={msize} -> {val}", flush=True)
    return val

if __name__ == "__main__":
    if "W" in os.environ:
        worker(int(os.environ["W"]), int(os.environ["NP"]), int(os.environ["MS"]))
    else:
        for ms in (256, 512, 1024):
            t1 = run(1, ms); t2 = run(2, ms)
            print(f"  msize={ms}: per-iter 1p={t1:.2f} 2p={t2:.2f} ovh={t2-t1:.2f} ms")
