"""aruco_slam_tpu — a JAX marker-SLAM engine.

A from-scratch reimplementation of the capabilities of the ``Aruco_Slam``
reference (single-process ROS/C++ EKF-SLAM with ArUco fiducials, see
reference ``src/aruco_slam.cpp``) as an idiomatic JAX/XLA/Pallas framework:

- ``ops``       — geometry, camera models, PnP, ArUco detection, Triton kernels
- ``models``    — EKF-SLAM core, factor graph, pose-graph / bundle-adjustment
- ``parallel``  — device-mesh sharding, distributed Schur-complement BA
- ``sim``       — synthetic world / trajectory / image generation (replaces Gazebo)
- ``io``        — map.txt schema, sequence containers, checkpointing
- ``utils``     — config system, metrics (ATE/RPE), structured logging

Everything on the compute path is pure-functional and jit/vmap/shard_map
compatible: state lives in fixed-capacity masked pytrees (XLA needs static
shapes), sequential EKF updates run under ``lax.scan``, and multi-chip
scaling uses ``jax.sharding.Mesh`` + collectives instead of a message bus.
"""

__version__ = "0.1.0"

# On the GPU, XLA may run f32 matmuls in TF32 (10-bit mantissa, ~1e-3
# relative error) — too coarse for covariance algebra: the EKF sigma
# recursion and BA normal equations lose positive-definiteness on long
# runs. Estimation math needs true f32 dots; the cost is negligible at our
# matrix sizes. Override with ARUCO_SLAM_TPU_MATMUL_PRECISION for a
# lower-precision experiment.
import os as _os

import jax as _jax

_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("ARUCO_SLAM_TPU_MATMUL_PRECISION", "highest"),
)
