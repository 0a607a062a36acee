"""Single-stream end-to-end latency (VERDICT round 2 item 9).

The reference is a live 30 Hz ROS node — the reference-shaped question is
"what latency does ONE robot get per frame", not batched throughput. This
measures the full live step (image -> detect -> PnP front-end -> EKF
update -> pose) as ONE jitted program at batch 1, per-frame p50/p99 over a
rendered sequence.

The probe also times a null program with the same output signature to
measure the dispatch + sync roundtrip, and a chained leg for the
device-only per-frame latency.

Writes a ``single_stream_latency`` section into benchmarks/results.json.
"""
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from aruco_slam_tpu import runner
from aruco_slam_tpu.models import ekf
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops.detector import DetectorConfig, detect_markers
from aruco_slam_tpu.ops.frontend import observations_from_corners
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.compile_cache import enable_compile_cache
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
CFG = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=24))
DET = DetectorConfig()
N_FRAMES = int(os.environ.get("LAT_FRAMES", "120"))


def build_step():
    upd = runner.frame_update_for(CFG, batched=False)

    def step(state, img, ew, edt):
        state = ekf.predict_block(
            state, ekf.Control(ew[:, 0], ew[:, 1], edt), CFG
        )
        det = detect_markers(img, DET)
        frame = observations_from_corners(
            det.ids, det.corners, det.valid, CAM, CFG
        )
        state = upd(state, frame, CFG)
        pose, cov = ekf.get_pose(state)
        return state, pose

    return jax.jit(step)


def percentiles(ts):
    a = np.sort(np.asarray(ts))
    return {
        "p50_ms": round(1e3 * float(np.percentile(a, 50)), 3),
        "p90_ms": round(1e3 * float(np.percentile(a, 90)), 3),
        "p99_ms": round(1e3 * float(np.percentile(a, 99)), 3),
        "min_ms": round(1e3 * float(a[0]), 3),
    }


def main():
    enable_compile_cache()
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        seq = synthetic.generate_sequence(
            synthetic.SimParams(duration=8.0, seed=0), level="images", camera=CAM
        )
    n = min(N_FRAMES, seq.num_frames)
    epf = seq.enc_per_frame
    # one transfer for the whole stack, then per-frame device-side slices
    imgs = jax.device_put(np.asarray(seq.images)[:n])
    ew = jax.device_put(np.asarray(seq.enc_w).reshape(-1, epf, 2)[:n])
    edt = jax.device_put(np.asarray(seq.enc_dt).reshape(-1, epf)[:n])
    frames = [(imgs[i], ew[i], edt[i]) for i in range(n)]
    jax.block_until_ready([f[0] for f in frames])

    step = build_step()
    state = ekf.init_state(CFG)
    state, pose = step(state, *frames[0])
    jax.block_until_ready(pose)

    # null program with the same output signature: measures the pure
    # dispatch + sync roundtrip included in the host-observed latency
    null = jax.jit(lambda s, i, w, d: (s, s.mu[:3]))
    s2, p2 = null(state, *frames[0])
    np.asarray(p2)
    null_ts = []
    for i in range(20):
        t0 = time.perf_counter()
        s2, p2 = null(state, *frames[i % n])
        jax.block_until_ready(p2)
        null_ts.append(time.perf_counter() - t0)
    null_ms = 1e3 * float(np.median(null_ts))

    state = ekf.init_state(CFG)
    state, pose = step(state, *frames[0])
    jax.block_until_ready(pose)
    ts = []
    for i in range(1, n):
        t0 = time.perf_counter()
        state, pose = step(state, *frames[i])
        jax.block_until_ready(pose)
        ts.append(time.perf_counter() - t0)

    host = percentiles(ts)

    # Device-side per-frame latency via the chained method (the roundtrip
    # subtraction above has ~ms noise and the device cost is sub-ms): K
    # sequential frame-steps state-chained inside ONE jitted program;
    # per-frame device latency = (t(k2) - t(k1)) / (k2 - k1).
    def chained(k):
        @jax.jit
        def run(state, img, w, d):
            def body(s, _):
                # value-dependence: fold a carry scalar into the image so
                # XLA cannot hoist the loop-invariant detect() out of the
                # scan (it would, and the delta would then time only the
                # EKF part)
                s2, _pose = step_fn(s, img + 1e-30 * s.mu[0], w, d)
                return s2, None

            s, _ = jax.lax.scan(body, state, None, length=k)
            return s.mu[:3]

        return run

    step_fn = step
    k1, k2 = 2, 12
    f1, f2 = chained(k1), chained(k2)
    np.asarray(f1(state, *frames[0]))
    np.asarray(f2(state, *frames[0]))
    t1 = t2 = float("inf")
    for i in range(6):
        t0 = time.perf_counter()
        jax.block_until_ready(f1(state, *frames[i % n]))
        t1 = min(t1, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jax.block_until_ready(f2(state, *frames[i % n]))
        t2 = min(t2, time.perf_counter() - t0)
    device_ms = 1e3 * (t2 - t1) / (k2 - k1)

    out = {
        "frames": n,
        "pipeline": "predict + detect(640x480) + PnP front-end + EKF update, batch 1, one jitted program",
        "host_observed": host,
        "dispatch_roundtrip_ms": round(null_ms, 3),
        "device_per_frame_ms_chained": round(device_ms, 3),
        "achievable_hz_host": round(1e3 / host["p50_ms"], 1),
        "achievable_hz_device": round(1e3 / max(device_ms, 1e-3), 1),
        "note": "host numbers include the dispatch + sync roundtrip; the "
                "chained leg is the device-only per-frame latency",
        "backend": jax.default_backend(),
    }
    print(json.dumps(out, indent=1))
    path = os.path.join(os.path.dirname(__file__), "results.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    results["single_stream_latency"] = out
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", path)


if __name__ == "__main__":
    main()
