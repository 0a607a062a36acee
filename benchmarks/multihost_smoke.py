"""Multi-host smoke test: 2 processes x 4 virtual CPU devices, one global
8-way mesh, distributed BA with cross-process collectives.

Validates the actual multi-host path (jax.distributed.initialize +
shard_map psum over the process boundary) that a multi-host GPU cluster
would use — no cluster required. Run:

    python benchmarks/multihost_smoke.py            # launches both workers
    # (workers re-invoke this file with WORKER=i)
"""

import os
import subprocess
import sys

COORD = "localhost:12355"
N_PROC = 2
DEV_PER_PROC = 4


def worker(pid: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=COORD, num_processes=N_PROC, process_id=pid
    )
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from aruco_slam_tpu.models import ba, graph_builder
    from aruco_slam_tpu.parallel import dist_ba
    from jax.sharding import Mesh

    n_dev = len(jax.devices())
    assert n_dev == N_PROC * DEV_PER_PROC, jax.devices()

    problem, true_poses, true_lms = graph_builder.synthetic_ba_problem(
        n_keyframes=64, n_landmarks=40, obs_per_kf=5, seed=7
    )
    sharded, lm_perm = dist_ba.partition_problem(problem, n_dev)
    mesh = Mesh(np.array(jax.devices()), (dist_ba.AXIS,))
    poses, lms, hist = dist_ba.solve_dist(
        sharded, mesh, iters=5, cg_iters=60, damping=1e-4
    )
    poses = np.asarray(poses)
    err = np.linalg.norm(poses[:, :2] - true_poses[:, :2], axis=1).mean()
    if pid == 0:
        import jax.numpy as jnp

        ref_p, ref_l, _ = ba.solve(
            __import__("jax").tree.map(jnp.asarray, problem),
            iters=5, cg_iters=60, damping=1e-4,
        )
        match = float(np.abs(poses - np.asarray(ref_p)).max())
        assert match < 1e-5, f"distributed != single-device: {match}"
        assert err < 0.1, f"distributed solve diverged: pose_err={err}"
        print(
            f"MULTIHOST_OK devices={n_dev} pose_err={err:.4f} "
            f"vs_single_device_max_diff={match:.6f}",
            flush=True,
        )
    jax.distributed.shutdown()


def main() -> None:
    procs = [
        subprocess.Popen(
            [sys.executable, __file__],
            env={**os.environ, "WORKER": str(i)},
            stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROC)
    ]
    try:
        out, _ = procs[0].communicate(timeout=420)
        for p in procs[1:]:
            p.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(out)
    assert "MULTIHOST_OK" in out, out


if __name__ == "__main__":
    if "WORKER" in os.environ:
        worker(int(os.environ["WORKER"]))
    else:
        main()
