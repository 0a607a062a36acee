"""Build the config-2 BA problem once (CPU EKF replay) and save it, so
solver variants can be compared quickly without re-running the filter."""
import pickle
import sys
import time

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from aruco_slam_tpu import runner
from aruco_slam_tpu.models import ekf as ekf_mod, graph_builder
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig

cfg = SlamConfig(ekf=EkfConfig(max_landmarks=128, max_observations_per_frame=16))
arena = synthetic.make_arena(n_markers=100, width=20.0, height=16.0)
seq = synthetic.generate_sequence(
    synthetic.SimParams(
        duration=210.0, profile="tour", tour_width=20.0, tour_height=16.0,
        tour_inset=1.6, encoder_noise=0.4, fov_deg=90.0,
        max_view_angle_deg=85.0, seed=11,
    ),
    marker_map=arena,
)
t0 = time.time()
data = runner.replay_data_from_sequence(seq, "obs")
ekf_result = runner.replay(data, cfg, None, "obs")
traj = np.asarray(ekf_result.trajectory)
print("ekf replay", time.time() - t0, "s", file=sys.stderr)

lms, ids, active = ekf_mod.get_map(ekf_result.final_state, cfg)
lms, ids, active = np.asarray(lms), np.asarray(ids), np.asarray(active)
init_landmarks = {int(ids[k]): lms[k] for k in range(len(ids)) if active[k]}
problem, lm_ids = graph_builder.build_from_sequence(
    seq, cfg, keyframe_stride=4, init_poses=traj, init_landmarks=init_landmarks,
)
id_to_true = {int(i): seq.true_landmarks[k] for k, i in enumerate(seq.true_landmark_ids)}
true_lms = np.stack([id_to_true[int(a)] for a in lm_ids])
with open("/tmp/config2_problem.pkl", "wb") as f:
    pickle.dump({
        "problem": jax.tree.map(np.asarray, problem),
        "lm_ids": np.asarray(lm_ids),
        "true_lms": true_lms,
        "true_pose_frames": seq.true_pose_frames,
    }, f)
print("saved", problem.poses.shape, problem.landmarks.shape, problem.obs_kf.shape)
