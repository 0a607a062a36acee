"""Does a denser factor graph (smaller keyframe stride) stiffen the flat
bend valley and pull the MAP solution toward truth?"""
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
from aruco_slam_tpu.models import ba, ekf as ekf_mod, graph_builder
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
data = runner.replay_data_from_sequence(seq, "obs")
ekf_result = runner.replay(data, cfg, None, "obs")
traj = np.asarray(ekf_result.trajectory)
lms, ids, active = ekf_mod.get_map(ekf_result.final_state, cfg)
lms, ids, active = np.asarray(lms), np.asarray(ids), np.asarray(active)
init_landmarks = {int(ids[k]): lms[k] for k in range(len(ids)) if active[k]}
id_to_true = {int(i): seq.true_landmarks[k] for k, i in enumerate(seq.true_landmark_ids)}

for stride in (4, 2, 1):
    problem, lm_ids = graph_builder.build_from_sequence(
        seq, cfg, keyframe_stride=stride, init_poses=traj, init_landmarks=init_landmarks,
    )
    true_lms = np.stack([id_to_true[int(a)] for a in lm_ids])
    problem_j = jax.tree.map(jnp.asarray, problem)
    t0 = time.time()
    p, l, s = jax.jit(
        lambda pr: ba.solve(pr, iters=20, cg_iters=200, damping=1e-4,
                            adaptive=True, deflate_gauge=True)
    )(problem_j)
    jax.block_until_ready(p)
    dt = time.time() - t0
    err = float(np.mean(np.linalg.norm(np.asarray(l)[:, :2] - true_lms[:, :2], axis=1)))
    print(f"stride={stride}: K={problem.poses.shape[0]} N={problem.obs_kf.shape[0]} "
          f"map_err={err:.4f} cost {float(s.initial_cost):.1f}->{float(s.final_cost):.2f} wall={dt:.1f}s")
