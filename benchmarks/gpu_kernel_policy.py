"""Times the frame-step backends on one GPU, end to end, to set the kernel
policy in ``runner.use_frame_kernel`` / ``runner.frame_update_for``:

- corner-level batched replay at bench.py's shape (batch 256, 60 s,
  max_landmarks 32): the vmapped XLA scan, the Triton EKF frame kernel
  with XLA's PnP front-end, and both Triton kernels;
- the same near the kernel's tile limit (max_landmarks 41), and one tile
  size up (84 landmarks, a 256 x 256 tile) to find where the tile stops
  fitting;
- single-stream replay at max_landmarks 32 and 512: the scan
  ``ekf.update``, ``ekf.update_fused``, and the Triton kernel at batch 1
  (per-frame ``frame_update`` inside the replay scan, and the batched
  replay at batch 1);
- the share of the detector's time spent in threshold + connected
  components at 640x480.

Run from the repository root on a GPU:

    python benchmarks/gpu_kernel_policy.py [bench|kernels|gate|single|ccl ...]
        [--out PATH]

With no section names it runs bench, gate, single and ccl. Prints one line
per measurement, with the card's SM clock and power draw sampled during
it, and writes them all to PATH (default
benchmarks/gpu_kernel_policy.json, gitignored).
"""

import argparse

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from aruco_slam_tpu import runner  # noqa: E402
from aruco_slam_tpu.ops import frontend  # noqa: E402
from aruco_slam_tpu.ops.kernels import pnp_frontend  # noqa: E402
from aruco_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig  # noqa: E402

RESULTS = []
SAMPLES = []  # (time, sm clock MHz, power draw W) from nvidia-smi


def sample_clocks(stop):
    while not stop.is_set():
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True,
        ).stdout.split(",")
        if len(out) == 2:
            SAMPLES.append((time.perf_counter(), float(out[0]), float(out[1])))
        stop.wait(0.25)


def record(**kw):
    RESULTS.append(kw)
    print(json.dumps(kw), flush=True)


def seconds(fn, reps=3):
    """(seconds per call, median SM MHz, median W) over the timed reps."""
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    t1 = time.perf_counter()
    window = [s for s in SAMPLES if t0 <= s[0] <= t1]
    mhz = float(np.median([s[1] for s in window])) if window else None
    watts = float(np.median([s[2] for s in window])) if window else None
    return (t1 - t0) / reps, mhz, watts


def xla_pnp(ids, corners, valid, camera, config, interpret=False):
    """XLA's vmapped front-end in the PnP kernel's calling convention."""
    return jax.vmap(
        lambda i, c, v: frontend.observations_from_corners(
            i, c, v, camera, config)
    )(ids, corners, valid)


def ekf_kernel_with_xla_pnp(data, cfg, cam):
    """The kernel replay traced with XLA's PnP front-end patched in. The
    jitted wrapper is its own function, so this trace never lands in the
    trace cache of runner._replay_batch_kernel."""
    real = pnp_frontend.pnp_frontend_batch
    pnp_frontend.pnp_frontend_batch = xla_pnp
    try:
        fn = jax.jit(
            lambda d, c: runner._replay_batch_kernel.__wrapped__(
                d, cfg, c, "corners"))
        jax.block_until_ready(fn(data, cam))
    finally:
        pnp_frontend.pnp_frontend_batch = real
    return lambda: fn(data, cam)


def batched(card, data, cam, max_lm, variants, tag, rounds=2):
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=max_lm, max_observations_per_frame=16)
    )
    frames = data.obs_ids.shape[0] * data.obs_ids.shape[1]
    fns = {
        "xla": lambda: runner._replay_batch_jit(data, cfg, cam, "corners"),
        "both_kernels": lambda: runner._replay_batch_kernel(
            data, cfg, cam, "corners"),
    }
    if "ekf_kernel" in variants:
        fns["ekf_kernel"] = ekf_kernel_with_xla_pnp(data, cfg, cam)
    runs = {v: [] for v in variants}
    for v in (variants + variants[::-1]) * rounds:  # A B B A A B B A
        try:
            runs[v].append(seconds(fns[v]))
        except Exception as e:  # a tile that does not fit is a finding
            record(tag=tag, variant=v, max_landmarks=max_lm,
                   error=f"{type(e).__name__}: {str(e)[:300]}")
            return
    for v in variants:
        t = min(r[0] for r in runs[v])
        record(tag=tag, variant=v, max_landmarks=max_lm, card=card,
               compile_cache=bool(jax.config.jax_enable_compilation_cache),
               seconds_per_replay=t, frames_per_sec=frames / t,
               runs_seconds_mhz_watts=runs[v])


def single_stream(card, max_lm):
    from aruco_slam_tpu.sim import synthetic

    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=60.0, seed=2, max_obs=16)
    )
    data = runner.replay_data_from_sequence(seq, "obs")
    base = dict(max_landmarks=max_lm, max_observations_per_frame=16)
    cfg = lambda **kw: SlamConfig(ekf=EkfConfig(**base, **kw))
    fns = {
        "scan": lambda: runner.replay(data, cfg(update_backend="xla")),
        "fused": lambda: runner.replay(data, cfg(fused_update=True)),
    }
    if max_lm <= runner.FRAME_KERNEL_MAX_LANDMARKS:
        data1 = jax.tree.map(lambda x: x[None], data)
        fns["triton_frame_update"] = lambda: runner.replay(
            data, cfg(update_backend="triton"))
        fns["triton_batch1_replay"] = lambda: runner._replay_batch_kernel(
            data1, cfg(), None, "obs")
    runs = {v: [] for v in fns}
    for v in list(fns) + list(fns)[::-1]:
        runs[v].append(seconds(fns[v]))
    for v in fns:
        t = min(r[0] for r in runs[v])
        record(tag="single_stream", variant=v, max_landmarks=max_lm,
               card=card, us_per_frame=t / seq.num_frames * 1e6,
               runs_seconds_mhz_watts=runs[v])


def ccl_share(card):
    from aruco_slam_tpu.ops import detector
    from aruco_slam_tpu.ops.camera import CameraIntrinsics
    from aruco_slam_tpu.sim import synthetic

    cam = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=1.6, seed=0), level="images", camera=cam
    )
    imgs = jnp.asarray(seq.images[:16])
    cfg = detector.DetectorConfig()
    r = cfg.adaptive_radius
    full = runner._detect_chunk_jit(cfg)
    thr = jax.jit(jax.vmap(lambda im: detector.adaptive_threshold(
        im, r, cfg.adaptive_C, cfg.mean_stride)))
    union = jax.jit(jax.vmap(
        lambda im: detector._union_masks_and_labels(im, r, cfg)))
    fg = thr(imgs)
    ccl = jax.jit(jax.vmap(lambda f: detector.label_components(
        f, cfg.ccl_rounds)))
    t_full = seconds(lambda: full(imgs), reps=10)[0]
    t_thr = seconds(lambda: thr(imgs), reps=10)[0]
    t_union = seconds(lambda: union(imgs), reps=10)[0]
    t_ccl = seconds(lambda: ccl(fg), reps=10)[0]
    record(tag="ccl_share", card=card, frames=16,
           detector_ms_per_frame=t_full / 16 * 1e3,
           threshold_ms_per_frame=t_thr / 16 * 1e3,
           threshold_close_both_ccl_ms_per_frame=t_union / 16 * 1e3,
           raw_ccl_ms_per_frame=t_ccl / 16 * 1e3,
           share_threshold_close_ccl=t_union / t_full)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sections", nargs="*",
                    default=["bench", "gate", "single", "ccl"])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "benchmarks", "gpu_kernel_policy.json"))
    args = ap.parse_args()
    which = args.sections
    if jax.devices()[0].platform != "gpu":
        sys.exit("gpu_kernel_policy: JAX found no GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card:", card, flush=True)
    stop = threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(stop,), daemon=True)
    sampler.start()
    import bench
    from aruco_slam_tpu.ops.camera import CameraIntrinsics

    cam0 = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    data, seqs = bench.build_data(batch=256, duration=60.0, cam=cam0)
    cam = seqs[0].camera()
    if "bench" in which:
        batched(card, data, cam, 32, ["xla", "ekf_kernel", "both_kernels"],
                "bench_shape")
    if "kernels" in which:
        batched(card, data, cam, 32, ["ekf_kernel", "both_kernels"],
                "bench_shape")
    if "gate" in which:
        batched(card, data, cam, 41, ["xla", "both_kernels"], "near_gate")
        batched(card, data, cam, 84, ["both_kernels", "xla"], "tile_256",
                rounds=1)
    if "single" in which:
        single_stream(card, 32)
        single_stream(card, 512)
    if "ccl" in which:
        ccl_share(card)
    stop.set()
    sampler.join(timeout=10)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(RESULTS, f, indent=1)


if __name__ == "__main__":
    main()
