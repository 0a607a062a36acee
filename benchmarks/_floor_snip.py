import os, sys, time
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu.ops import detector as det
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.sim import synthetic
CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
cpu = jax.devices("cpu")[0]
with jax.default_device(cpu):
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=4.0, seed=0), level="images", camera=CAM)
imgs = jnp.asarray(np.asarray(seq.images)[:32])
jax.block_until_ready(imgs)
def timeit(fn, *a, reps=7):
    out = fn(*a); np.asarray(jax.tree.leaves(out)[0])
    ts=[]
    for _ in range(reps):
        t0=time.perf_counter(); out=fn(*a); jax.block_until_ready(out); ts.append(time.perf_counter()-t0)
    return min(ts)
f0 = jax.jit(lambda x: x.sum())
t = timeit(f0, imgs)
print(f"dispatch floor: {1e3*t:.2f} ms/call = {1e3*t/32:.3f} ms/frame @B32")
# thr only, thr + XLA CCL at B=32
CFG = det.DetectorConfig()
f_thr = jax.jit(jax.vmap(lambda im: det.adaptive_threshold(im, CFG.adaptive_radius, CFG.adaptive_C, CFG.mean_stride)))
t = timeit(f_thr, imgs); print(f"thr xla s4    : {1e3*t/32:.3f} ms/frame")
f_tl = jax.jit(jax.vmap(lambda im: det._threshold_and_label(im, CFG.adaptive_radius, CFG)[1].sum()))
t = timeit(f_tl, imgs); print(f"thr+ccl xla   : {1e3*t/32:.3f} ms/frame")
