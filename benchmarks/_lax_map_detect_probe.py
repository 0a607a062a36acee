"""Probe: is detection inside lax.map over chunks as fast as the vmapped
detector? If so, the whole 1920-frame stack detects in ONE dispatch and
the per-dispatch overhead of the host chunk loop disappears."""
import os, sys, time
import jax
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax.numpy as jnp
from aruco_slam_tpu import runner
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.sim import synthetic

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(
        synthetic.SimParams(duration=13.0, seed=0), level="images", camera=CAM)
base = np.asarray(seq.images)[:128]
cfg = det.DetectorConfig()
F = int(os.environ.get("PROBE_F", "640"))
CH = int(os.environ.get("PROBE_CH", "16"))
imgs = jnp.asarray(np.concatenate([base] * (-(-F // 128)))[:F])
jax.block_until_ready(imgs)

@jax.jit
def detect_map(x):
    chunks = x.reshape(F // CH, CH, *x.shape[1:])
    return jax.lax.map(
        lambda c: jax.vmap(lambda im: det.detect_markers(im, cfg))(c), chunks
    )

out = detect_map(imgs)
np.asarray(out.ids)
best = float("inf")
for _ in range(3):
    t0 = time.perf_counter()
    out = detect_map(imgs)
    jax.block_until_ready(out)
    best = min(best, time.perf_counter() - t0)
print(f"lax.map F={F} chunk={CH}: {best/F*1e3:.3f} ms/frame ({F/best:.1f} fps)",
      flush=True)
