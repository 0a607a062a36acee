"""Benchmark harness (L7). Prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline: frames/s/chip of the full corner-level pipeline (batch-256
PnP + EKF replay over 8 distinct sequences — BASELINE.md config 3 shape)
on the default device. ``vs_baseline`` is measured against a single-thread dense float64
NumPy EKF equivalent to the reference's Eigen formulation (the reference
itself publishes no numbers — BASELINE.md), run on this host over the same
observation stream.
"""

import json
import os
import sys
import time

import numpy as np

# Pinned CPU-reference baseline (median of 7 runs of bench_reference_numpy,
# benchmarks/pin_baseline.py — 2026-08-17: [1713.6, 1806.4, 1718.3, 1778.7,
# 1805.4, 1914.8, 2165.7]), taken on the CPU of an earlier host, not the GPU
# host's: vs_baseline is comparable only with runs against the same pin
# until it is re-taken there (BASELINE.md). The live CPU leg varies ~2x with
# host load, which made vs_baseline swing between runs; vs_baseline is
# reported against this pin, with a single cheap live re-measure as a drift
# check (warn on stderr only).
PINNED_BASELINE_FPS = 1805.4


def build_data(batch, duration, cam, level="corners", distinct=8):
    import jax.numpy as jnp

    from aruco_slam_tpu import runner
    from aruco_slam_tpu.sim import synthetic

    seqs = [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=s),
            level=level,
            camera=cam,
        )
        for s in range(min(batch, distinct))
    ]
    data = runner.build_batch_data(seqs, batch, level)
    return data, seqs


def bench_replay(data, cfg, cam, level, reps=5):
    import jax

    from aruco_slam_tpu import runner

    out = runner.replay_batch(data, cfg, cam, level)  # compile + warmup
    jax.block_until_ready(out.trajectory)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = runner.replay_batch(data, cfg, cam, level)
        jax.block_until_ready(out.trajectory)
    dt = (time.perf_counter() - t0) / reps
    batch, frames = data.obs_ids.shape[:2]
    return batch * frames / dt, out


def bench_reference_numpy(seq, n_frames=150, marker_length=0.27):
    """Single-thread reference-equivalent pipeline for the same workload:
    per frame, per-marker iterative PnP (cv2.solvePnP IPPE_SQUARE, the same
    native path the reference uses via estimatePoseSingleMarkers) followed
    by the dense float64 EKF (reference Eigen formulation)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from reference_ekf import ReferenceEKF

    try:
        import cv2

        obj = np.array(
            [
                [-marker_length / 2, marker_length / 2, 0],
                [marker_length / 2, marker_length / 2, 0],
                [marker_length / 2, -marker_length / 2, 0],
                [-marker_length / 2, -marker_length / 2, 0],
            ]
        )
        # the sequence carries its own calibration (io.sequence.set_camera)
        seq_cam = seq.camera()
        K = np.asarray(seq_cam.matrix, np.float64)
        dist = np.asarray(seq_cam.dist, np.float64)
    except ImportError:
        cv2 = None
        print(
            "WARNING: cv2 missing — baseline omits per-marker PnP, "
            "vs_baseline not comparable to cv2-equipped runs",
            file=sys.stderr,
        )

    ekf = ReferenceEKF()
    epf = seq.enc_per_frame
    enc_w = seq.enc_w.reshape(-1, epf, 2)
    enc_dt = seq.enc_dt.reshape(-1, epf)
    n_frames = min(n_frames, seq.num_frames)
    t0 = time.perf_counter()
    for f in range(n_frames):
        for e in range(epf):
            ekf.add_encoder(enc_w[f, e, 0], enc_w[f, e, 1], enc_dt[f, e])
        obs = []
        for j in range(seq.max_obs):
            if not seq.obs_valid[f, j]:
                continue
            if cv2 is not None and seq.corners_px is not None:
                corners = seq.corners_px[f, j].astype(np.float64)
                cv2.solvePnP(
                    obj, corners.reshape(-1, 1, 2), K, dist,
                    flags=cv2.SOLVEPNP_IPPE_SQUARE,
                )
            obs.append(
                (int(seq.obs_ids[f, j]), seq.obs_z[f, j], seq.obs_R[f, j])
            )
        ekf.add_frame(obs)
    dt = time.perf_counter() - t0
    return n_frames / dt


def bench_image_level(cam, batch=32, duration=6.0):
    """Secondary metric: full image pipeline (rendered 640x480 frames ->
    detector -> PnP -> EKF) at batch 32 — BASELINE.md config 3b."""
    import jax
    import jax.numpy as jnp

    from aruco_slam_tpu import runner
    from aruco_slam_tpu.sim import synthetic
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
    cpu = jax.devices("cpu")[0]
    seqs = []
    with jax.default_device(cpu):
        for s in range(2):
            seqs.append(
                synthetic.generate_sequence(
                    synthetic.SimParams(duration=duration, seed=s),
                    level="images",
                    camera=cam,
                )
            )
    f = seqs[0].num_frames
    data = runner.build_batch_data(seqs, batch, "images")
    data = jax.tree.map(jnp.asarray, data)
    cam = seqs[0].camera()  # the calibration the sequence carries
    out = runner.replay_batch(data, cfg, cam, "images")
    jax.block_until_ready(out.trajectory)
    # median of 3, with a warning when the spread is wide
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = runner.replay_batch(data, cfg, cam, "images")
        jax.block_until_ready(out.trajectory)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    if ts[-1] > 1.5 * ts[0]:
        print(
            f"WARNING: image-level rep spread {ts[0]:.2f}-{ts[-1]:.2f} s",
            file=sys.stderr,
        )
    return batch * f / ts[len(ts) // 2]


def main():
    import jax

    from aruco_slam_tpu.ops.camera import CameraIntrinsics
    from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
    from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py: JAX found no GPU; device rates are not taken on "
                 f"{jax.devices()[0].platform!r}")
    enable_compile_cache()
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16))
    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    data, seqs = build_data(batch=256, duration=60.0, cam=cam)
    # replay with the camera the SEQUENCE carries, not the local variable —
    # the wiring the reference gets from its CameraInfo stream
    cam = seqs[0].camera()
    fps, _ = bench_replay(data, cfg, cam, "corners", reps=3)
    img_fps = round(bench_image_level(cam), 1)
    drift_fps = bench_reference_numpy(seqs[0], n_frames=60)
    if not (0.4 * PINNED_BASELINE_FPS < drift_fps < 2.5 * PINNED_BASELINE_FPS):
        print(
            f"WARNING: live CPU baseline {drift_fps:.0f} fps drifted >2.5x "
            f"from pinned {PINNED_BASELINE_FPS} — re-run "
            f"benchmarks/pin_baseline.py",
            file=sys.stderr,
        )
    print(
        json.dumps(
            {
                "metric": "ekf_pipeline_frames_per_sec_per_chip",
                "value": round(fps, 1),
                "unit": "frames/s",
                "vs_baseline": round(fps / PINNED_BASELINE_FPS, 2),
                "image_level_frames_per_sec_per_chip": img_fps,
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
