"""Bring-up check of the marker-SLAM main path on NVIDIA GPUs.

Drives each user entry point once at the sizes users run (runner replay at
obs, corner and image level, the streaming ``SlamSystem``, bundle
adjustment) and compares every phase with the repository's plain
reference. Each phase prints one line with what it compared, the
difference found and the tolerance used; a failed comparison stops the
run with a non-zero exit code. The last line of standard output is one
JSON object naming the device.

    python chip_smoke.py          # one GPU: phases 1-6
    python chip_smoke.py --four   # four GPUs: distributed BA and sharded
                                  # replay against their one-GPU runs

Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class PhaseFailed(AssertionError):
    pass


def report(phase: str, what: str, checks: list) -> None:
    """One line per phase: ``checks`` is [(name, diff, tol)]; passes when
    every diff <= tol (a tol of None only reports)."""
    parts = []
    failed = []
    for name, diff, tol in checks:
        if tol is None:
            parts.append(f"{name}={diff!r}")
            continue
        parts.append(f"{name}={diff!r} (tol {tol!r})")
        if not diff <= tol:
            failed.append(name)
    status = "FAIL " + ",".join(failed) if failed else "ok"
    print(f"[{phase}] {what}: {'; '.join(parts)} -> {status}", flush=True)
    if failed:
        raise PhaseFailed(f"{phase}: {failed}")


def timed(fn, reps: int = 3):
    """(seconds per call, last output): one warm-up call, then ``reps``
    calls each ending in block_until_ready."""
    import jax

    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# --------------------------------------------------------------------------
# Phase 1: device
# --------------------------------------------------------------------------


def phase_device(count: int) -> str:
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})"
        )
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    lines = card_line().splitlines()
    for line in lines:
        print(f"[device] card: {line}", flush=True)
    card = lines[0]
    print(
        f"[device] jax {jax.__version__} jaxlib {jaxlib.__version__} "
        f"devices {len(devs)} x {devs[0].device_kind} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        flush=True,
    )
    return card


# --------------------------------------------------------------------------
# Phase 2: single-sequence EKF replay vs the float64 oracle
# --------------------------------------------------------------------------


def feed_oracle(seq, n_frames=None):
    """Run tests/reference_ekf.py over a sequence's observation stream."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from reference_ekf import ReferenceEKF

    oracle = ReferenceEKF()
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    for f in range(n_frames or seq.num_frames):
        for e in range(epf):
            oracle.add_encoder(
                float(enc_w[f, e, 0]), float(enc_w[f, e, 1]),
                float(enc_dt[f, e]),
            )
        oracle.add_frame(
            [
                (int(seq.obs_ids[f, j]), seq.obs_z[f, j], seq.obs_R[f, j])
                for j in range(seq.max_obs)
                if seq.obs_valid[f, j]
            ]
        )
    return oracle


def phase_single(duration: float = 60.0) -> None:
    from aruco_slam_tpu import runner
    from aruco_slam_tpu.io import map_io
    from aruco_slam_tpu.sim import synthetic
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    # BASELINE.md config 1: the reference's 7-marker arena
    arena = map_io.load_map(os.path.join(ROOT, "map", "reference_arena.txt"))
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=8)
    )
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=duration, seed=2, max_obs=8),
        marker_map=arena,
    )
    res = runner.replay_sequence(seq, cfg, level="obs")
    oracle = feed_oracle(seq)
    n = 3 + 3 * len(oracle.id_map)
    mu = np.asarray(res.final_state.mu)
    sigma = np.asarray(res.final_state.sigma)
    report(
        "single", f"replay_sequence final state vs float64 oracle, "
        f"{seq.num_frames} frames, {len(oracle.id_map)} landmarks",
        [
            ("n_landmarks", abs(int(res.final_state.n_landmarks)
                                - len(oracle.id_map)), 0),
            ("mu", float(np.abs(mu[:n] - oracle.mu).max()), 2e-3),
            ("sigma", float(np.abs(sigma[:n, :n] - oracle.sigma).max()), 2e-3),
        ],
    )


# --------------------------------------------------------------------------
# Phase 3: corner-level batched replay at bench.py's shape
# --------------------------------------------------------------------------


def corner_data(batch: int, duration: float, n_markers: int | None = None):
    """bench.py's corner-level data: ``batch`` sequences tiled from 8
    distinct seeds. ``n_markers`` replaces the default 20-marker arena by a
    denser one of that many markers (same walls, same drive)."""
    import bench
    from aruco_slam_tpu import runner
    from aruco_slam_tpu.ops.camera import CameraIntrinsics
    from aruco_slam_tpu.sim import synthetic
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16)
    )
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    if n_markers is None:
        data, seqs = bench.build_data(batch=batch, duration=duration, cam=cam)
    else:
        arena = synthetic.make_arena(n_markers=n_markers)
        seqs = [
            synthetic.generate_sequence(
                synthetic.SimParams(duration=duration, seed=s),
                marker_map=arena, level="corners", camera=cam,
            )
            for s in range(min(batch, 8))
        ]
        data = runner.build_batch_data(seqs, batch, "corners")
    return data, cfg, seqs[0].camera()


def compare_replays(out, ref) -> list:
    """Kernel replay vs the vmapped XLA replay. Both run the same float32
    algebra, but the kernel sums in registers in another order than XLA's
    fused reductions, and 600 sequential frame updates carry the rounding
    forward: 1 mm / 1e-4 on pose and covariance, 1e-3 of the largest
    covariance entry, the landmark and dropped counts exact, every value
    finite."""
    sig_scale = float(np.abs(np.asarray(ref.final_state.sigma)).max())
    fields = (out.trajectory, out.pose_cov, out.final_state.mu,
              out.final_state.sigma)
    return [
        ("non-finite values", sum(int((~np.isfinite(np.asarray(x))).sum())
                                  for x in fields), 0),
        ("trajectory", float(np.abs(np.asarray(out.trajectory)
                                    - np.asarray(ref.trajectory)).max()), 1e-3),
        ("pose_cov", float(np.abs(np.asarray(out.pose_cov)
                                  - np.asarray(ref.pose_cov)).max()), 1e-4),
        ("n_landmarks", int(np.abs(np.asarray(out.n_landmarks)
                                   - np.asarray(ref.n_landmarks)).max()), 0),
        ("dropped", int(np.abs(np.asarray(out.final_state.dropped)
                               - np.asarray(ref.final_state.dropped)).max()), 0),
        ("sigma/max|sigma|", float(np.abs(np.asarray(out.final_state.sigma)
                                          - np.asarray(ref.final_state.sigma)
                                          ).max()) / sig_scale, 1e-3),
    ]


def phase_corners(card: str, batch: int = 256, duration: float = 60.0) -> None:
    from aruco_slam_tpu import runner

    data, cfg, cam = corner_data(batch, duration)
    frames = batch * data.obs_ids.shape[1]
    policy = "triton" if runner.use_frame_kernel(cfg) else "xla"
    t_pol, out = timed(lambda: runner.replay_batch(data, cfg, cam, "corners"))
    t_xla, ref = timed(
        lambda: runner._replay_batch_jit(data, cfg, cam, "corners")
    )
    print(
        f"[corners] batch {batch} x {data.obs_ids.shape[1]} frames on "
        f"{card}: policy ({policy}) {frames / t_pol:.1f} frames/s, "
        f"vmapped XLA {frames / t_xla:.1f} frames/s",
        flush=True,
    )
    report(
        "corners", f"replay_batch ({policy}) vs _replay_batch_jit",
        compare_replays(out, ref),
    )
    # the largest map the kernel's 128 x 128 tile holds, on a 64-marker
    # arena: every sequence fills all slots and then drops new markers
    gate = runner.FRAME_KERNEL_MAX_LANDMARKS
    data, cfg, cam = corner_data(batch, duration, n_markers=64)
    cfg = dataclasses.replace(
        cfg, ekf=dataclasses.replace(cfg.ekf, max_landmarks=gate)
    )
    out = runner.replay_batch(data, cfg, cam, "corners")
    ref = runner._replay_batch_jit(data, cfg, cam, "corners")
    filled = np.asarray(out.final_state.n_landmarks)
    report(
        "corners", f"at max_landmarks {gate}, 64-marker arena: replay_batch "
        f"({'triton' if runner.use_frame_kernel(cfg) else 'xla'}) vs "
        f"_replay_batch_jit",
        compare_replays(out, ref) + [
            ("sequences with a slot left", int((filled < gate).sum()), 0),
            ("sequences that dropped none", int(
                (np.asarray(out.final_state.dropped) == 0).sum()), 0),
        ],
    )


# --------------------------------------------------------------------------
# Phase 4: image-level replay and detection at three resolutions
# --------------------------------------------------------------------------


def detection_vs_truth(ids, corners, valid, seq):
    """(recall, mean corner error px) of detections [F, K] against the
    simulator's visible markers and projected corners."""
    ids, corners, valid = map(np.asarray, (ids, corners, valid))
    hits = total = 0
    errs = []
    for f in range(seq.num_frames):
        det = {int(i): corners[f, k] for k, i in enumerate(ids[f]) if valid[f, k]}
        for j in range(seq.max_obs):
            if not seq.obs_valid[f, j]:
                continue
            total += 1
            c = det.get(int(seq.obs_ids[f, j]))
            if c is not None:
                hits += 1
                errs.append(np.linalg.norm(c - seq.corners_px[f, j], axis=-1).mean())
    return hits / max(total, 1), float(np.mean(errs)) if errs else float("inf")


def phase_images(card: str, batch: int = 32, duration: float = 6.0,
                 cpu_frames: int = 16, hd_duration: float = 1.6) -> None:
    import jax

    from aruco_slam_tpu import runner
    from aruco_slam_tpu.ops.camera import CameraIntrinsics
    from aruco_slam_tpu.ops.detector import DetectorConfig
    from aruco_slam_tpu.sim import renderer, synthetic
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    # bench.py's image-level leg: 640x480, batch 32 over 2 distinct sequences
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24)
    )
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=s),
            level="images", camera=cam,
        )
        for s in range(2)
    ]
    data = runner.build_batch_data(seqs, batch, "images")
    frames = batch * seqs[0].num_frames
    t_img, out = timed(lambda: runner.replay_batch(data, cfg, cam, "images"))
    print(
        f"[images] 640x480 batch {batch} x {seqs[0].num_frames} frames on "
        f"{card}: {frames / t_img:.1f} frames/s (detect + PnP + EKF)",
        flush=True,
    )
    det_cfg = DetectorConfig()
    # the same detections through the vmapped XLA replay (24 observations
    # per frame: the kernel pads them to 32 rows)
    ref = runner._replay_batch_jit(
        runner._detections_to_corner_data(data, det_cfg), cfg, cam, "corners"
    )
    report(
        "images", f"replay_batch "
        f"({'triton' if runner.use_frame_kernel(cfg) else 'xla'}) vs "
        f"_replay_batch_jit on the same detections",
        compare_replays(out, ref),
    )
    ids, corners, valid = runner.detect_frames(data.images[:2], det_cfg)
    checks = []
    for s, seq in enumerate(seqs):
        rec, err = detection_vs_truth(ids[s], corners[s], valid[s], seq)
        checks += [(f"miss_rate[{s}]", 1.0 - rec, 0.3),
                   (f"corner_err_px[{s}]", err, 1.5)]
    # the simulator's visibility model (range, field of view, view angle)
    # counts markers too small or oblique to decode, so recall stays < 1
    report("images", "640x480 detections vs renderer truth", checks)

    # same jitted detector, CPU backend, same process
    imgs = np.asarray(seqs[0].images[:cpu_frames])
    ids_g, cor_g, val_g = map(np.asarray, runner.detect_frames(imgs, det_cfg))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ids_c, cor_c, val_c = map(
            np.asarray,
            runner.detect_frames(jax.device_put(imgs, cpu), det_cfg),
        )
    both = val_g & val_c
    report(
        "images", f"GPU vs CPU detector on {cpu_frames} frames",
        [
            ("valid_mismatch", int((val_g != val_c).sum()), 0),
            ("id_mismatch", int((ids_g[both] != ids_c[both]).sum()), 0),
            ("corner_px", float(np.abs(cor_g[both] - cor_c[both]).max())
             if both.any() else 0.0, 0.05),
        ],
    )

    # HD buckets through detect_frames
    arena = synthetic.make_arena()
    checks = []
    for h, w, f in ((720, 1280, 900.0), (1080, 1920, 1350.0)):
        cam_hd = CameraIntrinsics.create(f, f, w / 2.0, h / 2.0)
        seq = synthetic.generate_sequence(
            synthetic.SimParams(duration=hd_duration, seed=3),
            marker_map=arena, level="corners", camera=cam_hd,
        )
        imgs = renderer.render_sequence_frames(
            seq, arena, cam_hd, height=h, width=w
        )
        t0 = time.perf_counter()
        ids, corners, valid = runner.detect_frames(imgs, det_cfg)
        jax.block_until_ready(ids)
        dt = time.perf_counter() - t0
        rec, err = detection_vs_truth(ids, corners, valid, seq)
        checks += [(f"{h}p miss_rate", 1.0 - rec, 0.3),
                   (f"{h}p corner_err_px", err, 1.5),
                   (f"{h}p first-call s (compile incl.)", round(dt, 2), None)]
    report("images", "HD detect_frames vs renderer truth", checks)


# --------------------------------------------------------------------------
# Phase 5: streaming SlamSystem vs runner.replay
# --------------------------------------------------------------------------


def phase_streaming(n_frames: int = 40) -> None:
    from aruco_slam_tpu import runner
    from aruco_slam_tpu.ops.camera import CameraIntrinsics
    from aruco_slam_tpu.sim import synthetic
    from aruco_slam_tpu.system import SlamSystem
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24)
    )
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=n_frames / 10.0, seed=5),
        level="images", camera=cam,
    )
    slam = SlamSystem(cfg, camera=cam)
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    for f in range(seq.num_frames):
        for e in range(epf):
            slam.add_encoder(enc_w[f, e, 0], enc_w[f, e, 1], enc_dt[f, e])
        slam.add_image(seq.images[f])
    res = runner.replay(
        runner.replay_data_from_sequence(seq, "images"), cfg, cam, "images"
    )
    report(
        "streaming", f"SlamSystem add_encoder/add_image vs runner.replay, "
        f"{seq.num_frames} frames",
        [
            ("pose", float(np.abs(slam.pose()
                                  - np.asarray(res.trajectory[-1])).max()), 1e-4),
            ("n_landmarks", abs(int(slam.state.n_landmarks)
                                - int(res.final_state.n_landmarks)), 0),
        ],
    )


# --------------------------------------------------------------------------
# Phase 6: bundle adjustment
# --------------------------------------------------------------------------


def phase_ba(n_kf: int = 1000, n_lm: int = 500, big_kf: int = 10000,
             big_lm: int = 5000, cg_iters: int = 300) -> None:
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu.models import ba, graph_builder

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_ba import dense_gn_step

    # config 4 size: one Gauss-Newton step vs the dense float64 solve
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_kf, n_lm, obs_per_kf=8, seed=0
    )
    pj = jax.tree.map(jnp.asarray, problem)
    poses, lms, _ = jax.jit(
        lambda p: ba.solve(p, iters=1, cg_iters=cg_iters, damping=1e-6)
    )(pj)
    dp_ref, dl_ref = dense_gn_step(problem)

    def step_diff(new, old, ref):
        d = np.asarray(new, np.float64) - old - ref
        d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi  # solver wraps theta
        return float(np.abs(d).max())

    report(
        "ba", f"one GN step at {n_kf} kf / {n_lm} lm vs dense float64 "
        f"normal equations",
        [("pose_step", step_diff(poses, problem.poses, dp_ref), 5e-3),
         ("landmark_step", step_diff(lms, problem.landmarks, dl_ref), 5e-3)],
    )

    # config 5 size through the solver the `ba` CLI command calls
    problem, true_poses, _ = graph_builder.synthetic_ba_problem(
        big_kf, big_lm, obs_per_kf=8, seed=0
    )
    pj = jax.tree.map(jnp.asarray, problem)
    poses, _, stats = jax.jit(
        lambda p: ba.solve(p, iters=5, cg_iters=200, adaptive=True,
                           deflate_gauge=True)
    )(pj)
    err0 = np.linalg.norm(problem.poses[:, :2] - true_poses[:, :2], axis=1)
    err = np.linalg.norm(np.asarray(poses)[:, :2] - true_poses[:, :2], axis=1)
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    report(
        "ba", f"5 GN iterations at {big_kf} kf / {big_lm} lm "
        f"(cost {c0:.6g} -> {c1:.6g}; mean pose error vs truth "
        f"{err0.mean():.4f} -> {err.mean():.4f} m)",
        [("final/initial cost", c1 / c0, 0.5),
         ("mean pose error m", float(err.mean()), float(err0.mean()))],
    )


# --------------------------------------------------------------------------
# Phase 7 (--four): distributed BA and sharded replay across four GPUs
# --------------------------------------------------------------------------


def phase_four(card: str, batch: int = 256, duration: float = 60.0,
               n_kf: int = 10000, n_lm: int = 5000) -> None:
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu import runner
    from aruco_slam_tpu.models import ba, graph_builder
    from aruco_slam_tpu.parallel import dist_ba, mesh as mesh_lib

    devs = jax.devices()[:4]
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_kf, n_lm, obs_per_kf=8, seed=0
    )
    sharded, _ = dist_ba.partition_problem(problem, 4)
    mesh = mesh_lib.make_mesh(4, axis=dist_ba.AXIS)
    t_d, (poses_d, _, hist) = timed(
        lambda: dist_ba.solve_dist(sharded, mesh, iters=5, cg_iters=60,
                                   damping=1e-4), reps=2,
    )
    pj = jax.device_put(jax.tree.map(jnp.asarray, problem), devs[0])
    solve1 = jax.jit(
        lambda p: ba.solve(p, iters=5, cg_iters=60, damping=1e-4)
    )
    t_1, (poses_1, _, stats) = timed(lambda: solve1(pj), reps=2)
    print(
        f"[four] solve_dist {n_kf}/{n_lm} on {card} x4: "
        f"{t_d * 1e3:.1f} ms vs one GPU {t_1 * 1e3:.1f} ms per 5 GN",
        flush=True,
    )
    # 1 mm: the sharded solve sums the [K, 3] CG products in another order
    # (per-device partials + psum) than the single-device gather tables,
    # and 5 GN x 60 CG iterations carry that float32 rounding into poses
    # of ~10 m magnitude (ulp ~1e-6 m)
    report(
        "four", "dist_ba.solve_dist on 4 GPUs vs ba.solve on one",
        [("poses", float(np.abs(np.asarray(poses_d)
                                - np.asarray(poses_1)).max()), 1e-3),
         ("cost_history rel", float(np.abs(
             np.asarray(hist) / np.asarray(stats.cost_history) - 1).max()),
          1e-3)],
    )

    data, cfg, cam = corner_data(batch, duration)
    data1 = jax.device_put(data, devs[0])
    t_1, ref = timed(lambda: runner.replay_batch(data1, cfg, cam, "corners"))
    dmesh = mesh_lib.make_mesh(4, axis="dp")
    t_4, out = timed(
        lambda: runner.replay_sharded(data, cfg, dmesh, cam, "corners")
    )
    shards = {
        s.device.id: s.data.shape[0]
        for s in out.trajectory.addressable_shards
    }
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]
    frames = batch * data.obs_ids.shape[1]
    print(
        f"[four] replay_sharded batch {batch}: {frames / t_4:.1f} frames/s "
        f"on 4 GPUs vs {frames / t_1:.1f} on one; rows per device {shards}; "
        f"peak bytes per device {peaks}",
        flush=True,
    )
    checks = compare_replays(out, ref)
    checks.append(
        ("devices without an even share", sum(
            1 for d in devs if shards.get(d.id) != batch // 4), 0)
    )
    report("four", "replay_sharded on 4 GPUs vs replay_batch on one", checks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU comparisons (distributed BA, sharded "
        "replay)",
    )
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache

    count = 4 if args.four else 1
    card = phase_device(count)
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        phase_single()
        phase_corners(card)
        phase_images(card)
        phase_streaming()
        phase_ba()
    import jax

    dev = jax.devices()[0]
    print(f"[done] {time.perf_counter() - t0:.1f} s after device check",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
