"""Is the config-2 0.21 m floor solver-side or posterior-side?
Dense float64 exact GN from the EKF init + SE(2) alignment analysis."""
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_ba import dense_gn_step
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from aruco_slam_tpu.models import ba

with open("/tmp/config2_problem.pkl", "rb") as f:
    d = pickle.load(f)
problem_np = d["problem"]
true_lms = d["true_lms"]
problem = jax.tree.map(jnp.asarray, problem_np)

def map_err(lms):
    return float(np.mean(np.linalg.norm(np.asarray(lms)[:, :2] - true_lms[:, :2], axis=1)))

def se2_aligned_err(lms):
    """Procrustes SE(2) fit of estimate->truth, then residual."""
    A = np.asarray(lms)[:, :2]; B = true_lms[:, :2]
    ca, cb = A.mean(0), B.mean(0)
    A0, B0 = A - ca, B - cb
    U, _, Vt = np.linalg.svd(A0.T @ B0)
    R = (U @ Vt).T
    if np.linalg.det(R) < 0:
        U[:, -1] *= -1; R = (U @ Vt).T
    A_al = A0 @ R.T + cb
    return float(np.mean(np.linalg.norm(A_al - B, axis=1)))

# exact dense f64 LM from EKF init
poses = np.asarray(problem_np.poses, np.float64)
lms = np.asarray(problem_np.landmarks, np.float64)
cur = problem._replace(poses=jnp.asarray(poses, jnp.float32), landmarks=jnp.asarray(lms, jnp.float32))
prior_pose = jnp.asarray(problem_np.poses[0])
for i in range(30):
    dp, dl = dense_gn_step(cur, damping=1e-6)
    poses = poses + dp; lms = lms + dl
    poses[:, 2] = np.arctan2(np.sin(poses[:, 2]), np.cos(poses[:, 2]))
    lms[:, 2] = np.arctan2(np.sin(lms[:, 2]), np.cos(lms[:, 2]))
    cur = cur._replace(poses=jnp.asarray(poses, jnp.float32), landmarks=jnp.asarray(lms, jnp.float32))
    if i % 5 == 0 or i == 29:
        c = float(ba.cost(cur, cur.poses, cur.landmarks, prior_pose))
        print(f"dense f64 iter {i}: cost={c:.4f} map_err={map_err(lms):.4f} aligned={se2_aligned_err(lms):.4f}")
print("final dense:", map_err(lms), "aligned:", se2_aligned_err(lms))

# our solver's converged solution, aligned
p, l, s = jax.jit(lambda pr: ba.solve(pr, iters=20, cg_iters=200, damping=1e-4, adaptive=True, deflate_gauge=True))(problem)
print("schur-cg 20x200: map_err", map_err(l), "aligned", se2_aligned_err(l), "cost", float(s.final_cost))
