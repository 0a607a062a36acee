"""Scaling-efficiency measurement for the distributed BA backend
(BASELINE.md: >=80% scaling efficiency at N>=2 hosts).

It runs on CPU processes only (the distributed path on GPUs is checked
by ``chip_smoke.py --four``) and measures, explicitly labeled:

1. **Work balance** of ``dist_ba.partition_problem`` — the static property
   that determines scaling on real hardware (a shard that owns k times the
   observations runs k times longer between psums).
2. **Strong scaling** of ``dist_ba.solve_dist`` on an 8-way virtual CPU
   mesh (1 -> 8 devices, fixed problem, one process).
3. **Two-host efficiency** (the headline): the 2-way-sharded solve run as
   one process with both shards vs TWO processes with one shard each,
   cross-process collectives over gloo. Topology model: a "host" is one
   device thread plus a dedicated core pair (one core computes, one hosts
   the transport/OS — a real host never runs its NIC stack on the compute
   core). Leg A (1 host) is pinned to one core pair; leg B (2 hosts) to
   disjoint pairs. Efficiency = tA / tB with per-device work constant —
   the ideal distributed runtime adds nothing when the work is already
   sharded.

   Fairness control: leg A should not speed up much when given all four
   cores instead of two (the solve is dispatch-bound, a device thread
   cannot use extra cores), so leg B's second core serves only its
   transport, not extra compute.

   Methodology bugs this replaces: (a) ``solve_dist`` rebuilt its jit
   closure per call, so every "warm" timing was mostly retrace+recompile,
   which swamped the collective cost and inflated the per-psum overhead;
   (b) the 2x4 unpinned topology conflated per-psum cost with host-core
   oversubscription; a legacy 2x4 point is still recorded for continuity.

Writes a ``scaling`` section into benchmarks/results.json.
"""

import json
import os
import subprocess
import sys
import time

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    + os.environ.get("XLA_FLAGS", "")
)
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

N_KF, N_LM, OBS_PER_KF = 10240, 5120, 8
ITERS, CG = 2, 40


def n_collectives(iters: int, cg: int) -> int:
    """Collectives per solve: 1 CG-body psum per iteration + 1 fused
    linearization psum + 1 cost psum per GN step + the initial cost (see
    parallel/dist_ba.py; asserted from compiled HLO in
    tests/test_parallel.py)."""
    return iters * (cg + 2) + 1


def _solve_time(problem, n_dev, reps=3):
    from aruco_slam_tpu.parallel import dist_ba

    sharded, _ = dist_ba.partition_problem(problem, n_dev)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (dist_ba.AXIS,))
    run = lambda: dist_ba.solve_dist(
        sharded, mesh, iters=ITERS, cg_iters=CG, damping=1e-4
    )
    poses, _, _ = run()
    jax.block_until_ready(poses)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        poses, _, _ = run()
        jax.block_until_ready(poses)
        best = min(best, time.perf_counter() - t0)
    return best


def work_balance(problem, n_dev):
    from aruco_slam_tpu.parallel import dist_ba

    sharded, _ = dist_ba.partition_problem(problem, n_dev)
    # per-shard observation counts: the unit of per-device work between
    # collectives (linearize + Schur elimination are per-observation /
    # per-landmark local)
    valid = np.asarray(sharded.obs_valid).reshape(n_dev, -1)
    counts = valid.sum(axis=1)
    return {
        "obs_per_device": counts.tolist(),
        "imbalance_max_over_mean": float(counts.max() / counts.mean()),
    }


def _core_pair(i: int) -> str:
    ncores = os.cpu_count()
    half = ncores // 2
    return f"{i * half}-{(i + 1) * half - 1}"


def _run_legs(worker_env: dict, n_shards: int, pin: bool, tag: str,
              port: int) -> dict:
    """Time one (1-process vs n_shards-process) pair of legs. Both legs run
    the identical n_shards-way sharded program; pinning per _core_pair."""
    out = {}
    for n_proc in (1, 2):
        procs = []
        for i in range(n_proc):
            pre = ["taskset", "-c", _core_pair(i)] if pin else []
            procs.append(
                subprocess.Popen(
                    pre + [sys.executable, __file__],
                    env={
                        **os.environ,
                        **worker_env,
                        "SCALING_WORKER": str(i),
                        "SCALING_NPROC": str(n_proc),
                        "SCALING_NSHARDS": str(n_shards),
                        "SCALING_PORT": str(port),
                    },
                    stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        try:
            txt, _ = procs[0].communicate(timeout=1800)
            for p in procs[1:]:
                p.wait(timeout=60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        line = [l for l in txt.splitlines() if l.startswith("WORKER_TIME")]
        assert line, txt
        out[f"{n_proc}_process_s"] = float(line[0].split()[1])
    out["cross_process_efficiency"] = round(
        out["1_process_s"] / out["2_process_s"], 4
    )
    out["topology"] = tag
    return out


def two_host_leg(n_kf=N_KF, n_lm=N_LM, cg=CG, iters=ITERS, pin=True):
    """Headline leg: 2-way-sharded solve, 1 process x 2 devices vs
    2 processes x 1 device (see module docstring topology model)."""
    env = {
        "SCALING_WORKER_KF": str(n_kf),
        "SCALING_WORKER_LM": str(n_lm),
        "SCALING_WORKER_CG": str(cg),
        "SCALING_WORKER_ITERS": str(iters),
    }
    return _run_legs(env, 2, pin, "1x2dev vs 2x1dev, core-pair pinned",
                     12356)


def two_process_leg(n_kf=N_KF, n_lm=N_LM, cg=CG, iters=ITERS, pin=False):
    """Legacy round-3 topology (8-way sharded, 1x8 vs 2x4, unpinned):
    kept for cross-round continuity. Its 2-process leg adds in-process
    device-thread straggling on this 4-core host that two real hosts do
    not have — treat its implied overhead as an upper bound."""
    env = {
        "SCALING_WORKER_KF": str(n_kf),
        "SCALING_WORKER_LM": str(n_lm),
        "SCALING_WORKER_CG": str(cg),
        "SCALING_WORKER_ITERS": str(iters),
    }
    return _run_legs(env, 8, pin, "1x8dev vs 2x4dev, unpinned", 12356)


def efficiency_curve():
    """Cross-process efficiency vs compute-per-collective on the two-host
    topology, swept over problem size and CG depth.

    Hardware-independent argument: efficiency = c / (c + ovh) where ovh is
    the per-collective cost of crossing the process boundary (gloo TCP
    loopback here; a device interconnect such as NVLink is far cheaper) and
    c = t1 / n_psum is
    the compute-per-collective. Efficiency >= 0.8 whenever c >= 4 * ovh,
    regardless of transport."""
    sweep = [
        # (n_kf, n_lm, cg_iters, gn_iters)
        (2048, 1024, 40, 3),
        (2048, 1024, 200, 2),
        (10240, 5120, 40, 2),
        (10240, 5120, 200, 1),
        (40960, 20480, 40, 1),
        (40960, 20480, 200, 1),
    ]
    points = []
    for n_kf, n_lm, cg, iters in sweep:
        leg = two_host_leg(n_kf=n_kf, n_lm=n_lm, cg=cg, iters=iters)
        n_psum = n_collectives(iters, cg)
        ovh = (leg["2_process_s"] - leg["1_process_s"]) / n_psum
        points.append(
            {
                "keyframes": n_kf,
                "landmarks": n_lm,
                "cg_iters": cg,
                "gn_iters": iters,
                "n_collectives": n_psum,
                "1_process_s": leg["1_process_s"],
                "2_process_s": leg["2_process_s"],
                "efficiency": leg["cross_process_efficiency"],
                "compute_per_collective_ms": round(
                    1e3 * leg["1_process_s"] / n_psum, 3
                ),
                # upper bound: attributes the ENTIRE 2-process delta to the
                # collectives (ADVICE r3 item 3) — the direct measurement
                # is psum_boundary_cost
                "overhead_per_collective_ms_upper_bound": round(1e3 * ovh, 3),
            }
        )
        print(json.dumps(points[-1]), flush=True)
    above = [p for p in points if p["efficiency"] >= 0.8]
    return {
        "points": points,
        "efficiency_model": "eff = c / (c + ovh), c = compute-per-collective",
        "topology": "two-host (1x2dev vs 2x1dev, core-pair pinned)",
        "smallest_problem_at_80pct": (
            {k: above[0][k] for k in ("keyframes", "landmarks", "cg_iters")}
            if above else None
        ),
    }


def psum_microbench():
    """Per-collective boundary cost measured directly (not inferred from
    solve-time deltas): a lax.scan of 100 chained [K, 3] psums inside ONE
    jitted shard_map on the SAME two-host topology as the headline leg,
    timed 1-process vs 2-process. The delta / 100 is the per-psum cost of
    crossing the process boundary at that payload."""
    out = {}
    for n_kf in (2048, 10240, 40960):
        row = {}
        for n_proc in (1, 2):
            procs = [
                subprocess.Popen(
                    ["taskset", "-c", _core_pair(i), sys.executable, __file__],
                    env={
                        **os.environ,
                        "PSUM_WORKER": str(i),
                        "SCALING_NPROC": str(n_proc),
                        "SCALING_NSHARDS": "2",
                        "SCALING_WORKER_KF": str(n_kf),
                        "SCALING_PORT": "12357",
                    },
                    stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
                for i in range(n_proc)
            ]
            try:
                txt, _ = procs[0].communicate(timeout=900)
                for p in procs[1:]:
                    p.wait(timeout=60)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            line = [l for l in txt.splitlines() if l.startswith("PSUM_TIME")]
            assert line, txt
            row[f"{n_proc}_process_us_per_psum"] = float(line[0].split()[1])
        row["boundary_overhead_us_per_psum"] = round(
            row["2_process_us_per_psum"] - row["1_process_us_per_psum"], 1
        )
        row["payload_kib"] = round(n_kf * 3 * 4 / 1024, 1)
        out[str(n_kf)] = row
        print(json.dumps({n_kf: row}), flush=True)
    return out


def _init_worker(n_proc: int, n_shards: int) -> None:
    dev_per_proc = n_shards // n_proc
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev_per_proc}"
    )


def psum_worker(pid: int, n_proc: int) -> None:
    n_shards = int(os.environ.get("SCALING_NSHARDS", 2))
    _init_worker(n_proc, n_shards)
    if n_proc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{os.environ['SCALING_PORT']}",
            num_processes=n_proc,
            process_id=pid,
        )
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    n_kf = int(os.environ["SCALING_WORKER_KF"])
    mesh = Mesh(np.array(jax.devices()), ("x",))
    N_PSUM = 100

    @jax.jit
    @partial(
        shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
        check_rep=False,
    )
    def chain(x):
        # replicated [K, 3] operand — the payload dist_ba's Schur matvec
        # psums once per CG iteration
        def body(c, _):
            # data-dependent chain: each psum consumes the previous result
            s = jax.lax.psum(c, "x")
            return c + s * 1e-9, None

        c, _ = jax.lax.scan(body, x, None, length=N_PSUM)
        return c

    x = jnp.ones((n_kf, 3), jnp.float32)
    y = chain(x)
    jax.block_until_ready(y)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        y = chain(x)
        jax.block_until_ready(y)
        best = min(best, time.perf_counter() - t0)
    if pid == 0:
        print(f"PSUM_TIME {1e6 * best / N_PSUM:.1f}", flush=True)
    if n_proc > 1:
        jax.distributed.shutdown()


def worker(pid: int, n_proc: int) -> None:
    n_shards = int(os.environ.get("SCALING_NSHARDS", 2))
    _init_worker(n_proc, n_shards)
    if n_proc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{os.environ['SCALING_PORT']}",
            num_processes=n_proc,
            process_id=pid,
        )
    from aruco_slam_tpu.models import graph_builder
    from aruco_slam_tpu.parallel import dist_ba

    n_dev = len(jax.devices())
    assert n_dev == n_shards, jax.devices()
    problem, _, _ = graph_builder.synthetic_ba_problem(
        int(os.environ["SCALING_WORKER_KF"]),
        int(os.environ["SCALING_WORKER_LM"]),
        obs_per_kf=OBS_PER_KF,
        seed=0,
    )
    sharded, _ = dist_ba.partition_problem(problem, n_dev)
    mesh = Mesh(np.array(jax.devices()), (dist_ba.AXIS,))
    w_cg = int(os.environ.get("SCALING_WORKER_CG", CG))
    w_iters = int(os.environ.get("SCALING_WORKER_ITERS", ITERS))
    run = lambda: dist_ba.solve_dist(
        sharded, mesh, iters=w_iters, cg_iters=w_cg, damping=1e-4
    )
    poses, _, _ = run()
    jax.block_until_ready(poses)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        poses, _, _ = run()
        jax.block_until_ready(poses)
        best = min(best, time.perf_counter() - t0)
    if pid == 0:
        print(f"WORKER_TIME {best:.4f}", flush=True)
    if n_proc > 1:
        jax.distributed.shutdown()


def main():
    from aruco_slam_tpu.models import graph_builder

    problem, _, _ = graph_builder.synthetic_ba_problem(
        N_KF, N_LM, obs_per_kf=OBS_PER_KF, seed=0
    )
    result = {
        "problem": {"keyframes": N_KF, "landmarks": N_LM, "obs_per_kf": OBS_PER_KF},
        "note": (
            "headline = two-host topology (see benchmarks/scaling.py "
            "docstring); work balance and collective counts are the "
            "hardware-independent evidence (counts asserted in "
            "tests/test_parallel.py)"
        ),
        "work_balance": {
            str(n): work_balance(problem, n) for n in (2, 4, 8)
        },
    }
    strong = {}
    for n in (1, 2, 4, 8):
        strong[str(n)] = round(_solve_time(problem, n), 4)
    result["strong_scaling_wall_s"] = strong
    result["two_host"] = two_host_leg()
    # legacy 2x4 unpinned point kept for the record: its delta vs the
    # two-host leg is the in-process straggler artifact round 3 conflated
    # into "per-collective overhead" (ADVICE r3 item 3)
    result["legacy_2x4_unpinned"] = two_process_leg()
    result["psum_boundary_cost"] = psum_microbench()
    result["efficiency_curve"] = efficiency_curve()
    # Where does >=80% hold? eff = c / (c + ovh): the solve's
    # compute-per-collective c (measured, 1-process leg) vs the DIRECTLY
    # measured per-psum boundary overhead at that payload (gloo TCP
    # loopback transport; the same [K, 3] psum over NVLink is not
    # measured yet).
    thresh = {}
    for k, row in result["psum_boundary_cost"].items():
        ovh_ms = row["boundary_overhead_us_per_psum"] / 1e3
        pts = [
            p for p in result["efficiency_curve"]["points"]
            if str(p["keyframes"]) == k
        ]
        thresh[k] = {
            "boundary_overhead_ms": round(ovh_ms, 3),
            "compute_per_collective_ms_for_80pct": round(4 * ovh_ms, 3),
            "measured_compute_per_collective_ms": [
                p["compute_per_collective_ms"] for p in pts
            ],
            "predicted_efficiency": [
                round(
                    p["compute_per_collective_ms"]
                    / (p["compute_per_collective_ms"] + ovh_ms),
                    3,
                )
                for p in pts
            ],
            "measured_efficiency": [p["efficiency"] for p in pts],
        }
    result["efficiency_threshold"] = thresh
    path = os.path.join(os.path.dirname(__file__), "results.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    results["scaling"] = result
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    if "PSUM_WORKER" in os.environ:
        psum_worker(int(os.environ["PSUM_WORKER"]), int(os.environ["SCALING_NPROC"]))
    elif "SCALING_WORKER" in os.environ:
        worker(int(os.environ["SCALING_WORKER"]), int(os.environ["SCALING_NPROC"]))
    else:
        main()
