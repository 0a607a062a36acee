"""Bundle-adjustment backend tests: Schur-CG GN step vs a dense float64
normal-equations oracle, convergence on synthetic problems, loop closure,
and sequence-built graphs (SURVEY.md section 4, BASELINE.md configs 2/4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aruco_slam_tpu.models import ba, graph_builder
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import EkfConfig, SlamConfig


def dense_gn_step(problem, damping=1e-6):
    """Oracle: one Gauss-Newton step via the full dense (3K+3L) normal
    equations in float64."""
    poses = np.asarray(problem.poses, np.float64)
    lms = np.asarray(problem.landmarks, np.float64)
    K, L = len(poses), len(lms)
    n = 3 * K + 3 * L
    H = np.zeros((n, n))
    b = np.zeros(n)

    def h_jac(p, t):
        x, y, th = p
        s, c = np.sin(th), np.cos(th)
        dx, dy = t[0] - x, t[1] - y
        h = np.array(
            [
                dx * c + dy * s,
                -dx * s + dy * c,
                np.arctan2(np.sin(t[2] - th), np.cos(t[2] - th)),
            ]
        )
        Jp = np.array(
            [
                [-c, -s, -dx * s + dy * c],
                [s, -c, -dx * c - dy * s],
                [0, 0, -1],
            ]
        )
        Jt = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        return h, Jp, Jt

    for i in range(len(problem.obs_kf)):
        if not problem.obs_valid[i]:
            continue
        k, l = int(problem.obs_kf[i]), int(problem.obs_lm[i])
        h, Jp, Jl = h_jac(poses[k], lms[l])
        r = np.asarray(problem.obs_z[i], np.float64) - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        W = np.asarray(problem.obs_w[i], np.float64)
        sk, sl = 3 * k, 3 * K + 3 * l
        H[sk:sk + 3, sk:sk + 3] += Jp.T @ W @ Jp
        H[sl:sl + 3, sl:sl + 3] += Jl.T @ W @ Jl
        H[sk:sk + 3, sl:sl + 3] += Jp.T @ W @ Jl
        H[sl:sl + 3, sk:sk + 3] += Jl.T @ W @ Jp
        b[sk:sk + 3] += Jp.T @ W @ r
        b[sl:sl + 3] += Jl.T @ W @ r

    for i in range(len(problem.odo_i)):
        if not problem.odo_valid[i]:
            continue
        a, c2 = int(problem.odo_i[i]), int(problem.odo_j[i])
        h, Ji, Jj = h_jac(poses[a], poses[c2])
        r = np.asarray(problem.odo_z[i], np.float64) - h
        r[2] = np.arctan2(np.sin(r[2]), np.cos(r[2]))
        W = np.asarray(problem.odo_w[i], np.float64)
        sa, sc = 3 * a, 3 * c2
        H[sa:sa + 3, sa:sa + 3] += Ji.T @ W @ Ji
        H[sc:sc + 3, sc:sc + 3] += Jj.T @ W @ Jj
        H[sa:sa + 3, sc:sc + 3] += Ji.T @ W @ Jj
        H[sc:sc + 3, sa:sa + 3] += Jj.T @ W @ Ji
        b[sa:sa + 3] += Ji.T @ W @ r
        b[sc:sc + 3] += Jj.T @ W @ r

    H[:3, :3] += np.asarray(problem.prior_w, np.float64)
    H += damping * np.eye(n)
    d = np.linalg.solve(H, b)
    return d[: 3 * K].reshape(K, 3), d[3 * K:].reshape(L, 3)


def test_schur_cg_step_matches_dense_oracle():
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=12, n_landmarks=8, obs_per_kf=4, seed=1
    )
    problem = jax.tree.map(jnp.asarray, problem)
    # one GN iteration with many CG iters ~ exact solve
    poses, lms, _ = jax.jit(
        lambda p: ba.solve(p, iters=1, cg_iters=200, damping=1e-6)
    )(problem)
    dp = np.asarray(poses) - np.asarray(problem.poses)
    dl = np.asarray(lms) - np.asarray(problem.landmarks)
    dp_ref, dl_ref = dense_gn_step(problem)
    np.testing.assert_allclose(dp, dp_ref, atol=5e-3)
    np.testing.assert_allclose(dl, dl_ref, atol=5e-3)


def test_ba_converges_to_ground_truth():
    problem, true_poses, true_lms = graph_builder.synthetic_ba_problem(
        n_keyframes=60, n_landmarks=30, obs_per_kf=6, init_noise=0.15, seed=2
    )
    problem = jax.tree.map(jnp.asarray, problem)
    poses, lms, stats = jax.jit(
        lambda p: ba.solve(p, iters=8, cg_iters=60, damping=1e-4)
    )(problem)
    assert float(stats.final_cost) < float(stats.initial_cost) * 0.05
    # recovered within the measurement-noise floor
    err = np.linalg.norm(np.asarray(poses)[:, :2] - true_poses[:, :2], axis=1)
    assert err.mean() < 0.03, err.mean()
    lerr = np.linalg.norm(np.asarray(lms)[:, :2] - true_lms[:, :2], axis=1)
    assert lerr.mean() < 0.03, lerr.mean()


def test_unrolled_gn_loop_matches_scan():
    """``unroll=True`` (the throughput-bench path: no scan boundary between
    GN iterations) must produce the same solution and
    cost history as the default scan, up to f32 fusion-order rounding."""
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=60, n_landmarks=25, obs_per_kf=4, init_noise=0.2, seed=5
    )
    packed, tables, static = ba.prepare(problem)
    kw = dict(iters=4, cg_iters=25, damping=1e-4, tables=tables, **static)
    p_s, l_s, s_s = ba.solve(packed, **kw)
    p_u, l_u, s_u = ba.solve(packed, unroll=True, **kw)
    np.testing.assert_allclose(np.asarray(p_u), np.asarray(p_s), atol=1e-5)
    np.testing.assert_allclose(np.asarray(l_u), np.asarray(l_s), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(s_u.cost_history), np.asarray(s_s.cost_history), rtol=1e-5
    )
    assert s_u.cost_history.shape == (5,)
    # the emitted history must equal an explicit per-state recompute
    prior = packed.poses[0]
    c_explicit = float(ba.cost(packed, p_u, l_u, prior))
    np.testing.assert_allclose(
        float(s_u.final_cost), c_explicit, rtol=1e-6
    )


def test_cost_monotone_under_lm_damping():
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=40, n_landmarks=20, obs_per_kf=5, init_noise=0.3, seed=3
    )
    problem = jax.tree.map(jnp.asarray, problem)
    _, _, stats = ba.solve(problem, iters=6, cg_iters=50, damping=1e-3)
    hist = np.asarray(stats.cost_history)
    assert hist[-1] < hist[0]
    # overall decrease by a large factor
    assert hist[-1] < 0.05 * hist[0]


def test_pose_graph_loop_closure():
    """Odometry-only chain with drift + one loop-closure factor: the
    pose-graph solve (no landmarks) must pull the loop shut
    (BASELINE.md config 2 mechanism)."""
    rng = np.random.default_rng(0)
    K = 50
    # true: circle
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    r = 3.0
    true_poses = np.stack(
        [r * np.cos(t), r * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))], axis=1
    )

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[0] - a[0], b[1] - a[1]
        return np.array(
            [dx * c + dy * s, -dx * s + dy * c,
             np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))]
        )

    odo = np.stack([rel(true_poses[i], true_poses[i + 1]) for i in range(K - 1)])
    odo += rng.normal(scale=0.01, size=odo.shape) + np.array([0.004, 0.0, 0.002])
    # dead-reckoned init (drifts)
    poses = np.zeros((K, 3))
    poses[0] = true_poses[0]
    for i in range(K - 1):
        c, s = np.cos(poses[i, 2]), np.sin(poses[i, 2])
        poses[i + 1] = [
            poses[i, 0] + c * odo[i, 0] - s * odo[i, 1],
            poses[i, 1] + s * odo[i, 0] + c * odo[i, 1],
            np.arctan2(np.sin(poses[i, 2] + odo[i, 2]), np.cos(poses[i, 2] + odo[i, 2])),
        ]
    drift = np.linalg.norm(poses[-1, :2] - true_poses[-1, :2])
    # loop closure K-1 -> 0
    lc = rel(true_poses[-1], true_poses[0])
    eye = np.eye(3)
    problem = ba.BAProblem(
        poses=jnp.asarray(poses, jnp.float32),
        landmarks=jnp.zeros((1, 3), jnp.float32),
        obs_kf=jnp.zeros((1,), jnp.int32),
        obs_lm=jnp.zeros((1,), jnp.int32),
        obs_z=jnp.zeros((1, 3), jnp.float32),
        obs_w=jnp.zeros((1, 3, 3), jnp.float32),
        obs_valid=jnp.zeros((1,), bool),
        odo_i=jnp.asarray(np.r_[np.arange(K - 1), K - 1], jnp.int32),
        odo_j=jnp.asarray(np.r_[np.arange(1, K), 0], jnp.int32),
        odo_z=jnp.asarray(np.concatenate([odo, lc[None]]), jnp.float32),
        odo_w=jnp.asarray(np.tile(eye / 0.01**2, (K, 1, 1)), jnp.float32),
        odo_valid=jnp.ones((K,), bool),
        prior_w=jnp.asarray(1e8 * eye, jnp.float32),
    )
    new_poses, _, stats = ba.solve(problem, iters=6, cg_iters=80, damping=1e-4)
    err_after = np.linalg.norm(np.asarray(new_poses)[:, :2] - true_poses[:, :2], axis=1).mean()
    err_before = np.linalg.norm(poses[:, :2] - true_poses[:, :2], axis=1).mean()
    assert drift > 0.15  # the chain really drifted
    assert err_after < 0.35 * err_before, (err_before, err_after)


def test_build_from_sequence_and_refine():
    """EKF-level sequence -> factor graph -> BA; map error must beat the
    dead-reckoned initialization."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16))
    p = synthetic.SimParams(duration=20.0, seed=5, encoder_noise=1.0)
    seq = synthetic.generate_sequence(p)
    problem, lm_ids = graph_builder.build_from_sequence(seq, cfg, keyframe_stride=2)
    problem_j = jax.tree.map(jnp.asarray, problem)
    poses, lms, stats = jax.jit(
        lambda pr: ba.solve(pr, iters=6, cg_iters=60, damping=1e-4)
    )(problem_j)
    assert float(stats.final_cost) < float(stats.initial_cost)
    # landmark error vs ground truth by id
    id_to_true = {int(i): seq.true_landmarks[k] for k, i in enumerate(seq.true_landmark_ids)}
    before = after = 0.0
    for slot, aid in enumerate(lm_ids):
        t = id_to_true[int(aid)]
        before += np.linalg.norm(np.asarray(problem.landmarks)[slot, :2] - t[:2])
        after += np.linalg.norm(np.asarray(lms)[slot, :2] - t[:2])
    assert after < before, (before, after)


def test_pose_graph_api():
    """models.pose_graph thin API: chain + loop closure."""
    from aruco_slam_tpu.models import pose_graph

    rng = np.random.default_rng(3)
    K = 30
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    true_poses = np.stack(
        [2 * np.cos(t), 2 * np.sin(t), np.arctan2(np.cos(t), -np.sin(t))], axis=1
    )

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[0] - a[0], b[1] - a[1]
        return np.array([dx * c + dy * s, -dx * s + dy * c,
                         np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])

    odo = np.stack([rel(true_poses[i], true_poses[i + 1]) for i in range(K - 1)])
    odo += rng.normal(scale=0.01, size=odo.shape) + np.array([0.005, 0, 0.003])
    init = np.zeros((K, 3))
    init[0] = true_poses[0]
    for i in range(K - 1):
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[i + 1] = [init[i, 0] + c * odo[i, 0] - s * odo[i, 1],
                       init[i, 1] + s * odo[i, 0] + c * odo[i, 1],
                       init[i, 2] + odo[i, 2]]
    g = pose_graph.build(
        init, odo, odo_info=1e4,
        closures=[(K - 1, 0, rel(true_poses[-1], true_poses[0]), 1e4)],
    )
    poses, stats = pose_graph.solve(g)
    err_before = np.linalg.norm(init[:, :2] - true_poses[:, :2], axis=1).mean()
    err_after = np.linalg.norm(np.asarray(poses)[:, :2] - true_poses[:, :2], axis=1).mean()
    assert err_after < 0.5 * err_before, (err_before, err_after)


def _rotate_about_anchor(poses, lms, phi):
    """Displace a solution along the near-flat gauge mode: rotate every
    pose k>=1 and every landmark about pose 0's position by phi, keeping
    pose 0 itself fixed (the prior anchors pose 0 at its init, so rotating
    it too would be an exact gauge transform with zero cost gradient; with
    pose 0 held, only the first odometry factors resist — the flattest
    non-null direction of the posterior)."""
    c, s = np.cos(phi), np.sin(phi)
    R = np.array([[c, -s], [s, c]])
    anchor = poses[0, :2]
    p = poses.copy()
    p[1:, :2] = (poses[1:, :2] - anchor) @ R.T + anchor
    p[1:, 2] = poses[1:, 2] + phi
    l = lms.copy()
    l[:, :2] = (lms[:, :2] - anchor) @ R.T + anchor
    l[:, 2] = lms[:, 2] + phi
    return p, l


def test_gauge_deflation_recovers_flat_mode():
    """Init displaced along the global-rotation gauge mode: block-Jacobi CG
    crawls along this near-flat mode, the deflated solve
    must recover it in a handful of iterations."""
    problem, true_poses, true_lms = graph_builder.synthetic_ba_problem(
        n_keyframes=200, n_landmarks=60, obs_per_kf=4, obs_sigma=0.02,
        odo_sigma=0.1, init_noise=0.0, seed=9
    )
    p0, l0 = _rotate_about_anchor(
        np.asarray(problem.poses), np.asarray(problem.landmarks), 0.1
    )
    problem = problem._replace(
        poses=jnp.asarray(p0, jnp.float32), landmarks=jnp.asarray(l0, jnp.float32)
    )
    # tight budget: 3 GN x 30 CG (measured: plain 0.25 m, deflated 0.10 m)
    kw = dict(iters=3, cg_iters=30, damping=1e-6)
    _, lms_plain, _ = jax.jit(lambda p: ba.solve(p, **kw))(problem)
    _, lms_defl, _ = jax.jit(
        lambda p: ba.solve(p, deflate_gauge=True, **kw)
    )(problem)
    err_plain = np.linalg.norm(
        np.asarray(lms_plain)[:, :2] - true_lms[:, :2], axis=1
    ).mean()
    err_defl = np.linalg.norm(
        np.asarray(lms_defl)[:, :2] - true_lms[:, :2], axis=1
    ).mean()
    assert err_defl < 0.12, err_defl
    assert err_defl < 0.5 * err_plain, (err_plain, err_defl)


def test_adaptive_lm_rejects_bad_steps():
    """A hostile init (large noise) with low damping: fixed-damping GN can
    oscillate/diverge, adaptive LM must end at a cost no worse and keep the
    history monotone non-increasing after the first accept."""
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=40, n_landmarks=20, obs_per_kf=5, init_noise=0.6, seed=11
    )
    problem = jax.tree.map(jnp.asarray, problem)
    _, _, stats_ad = ba.solve(problem, iters=10, cg_iters=40, damping=1e-6,
                              adaptive=True)
    hist = np.asarray(stats_ad.cost_history)
    assert np.all(np.diff(hist) <= 1e-4 * hist[0]), hist
    assert hist[-1] < hist[0]


def test_packed_fast_path_matches_default_solve():
    """ba.prepare (kf-major packing + chain odometry + sorted-segmented-
    scan landmark reduction) must reproduce the plain segment_sum solve to
    f32 reassociation tolerance — on a problem with UNEVEN per-keyframe
    observation counts so the padding path is exercised."""
    problem, _, _ = graph_builder.synthetic_ba_problem(
        n_keyframes=40, n_landmarks=25, obs_per_kf=5, seed=3
    )
    # make counts uneven: invalidate a scattered subset of observations
    rng = np.random.default_rng(0)
    valid = np.asarray(problem.obs_valid).copy()
    valid[rng.choice(len(valid), size=30, replace=False)] = False
    problem = problem._replace(obs_valid=valid)
    base = jax.tree.map(jnp.asarray, problem)
    p0, l0, s0 = jax.jit(
        lambda p: ba.solve(p, iters=4, cg_iters=60, damping=1e-4)
    )(base)
    packed, tables, static = ba.prepare(problem)
    assert static["odo_chain"] is True
    p1, l1, s1 = jax.jit(
        lambda p, t: ba.solve(
            p, iters=4, cg_iters=60, damping=1e-4, tables=t, **static
        )
    )(packed, tables)
    np.testing.assert_allclose(np.asarray(p0), np.asarray(p1), atol=2e-4)
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=2e-4)
    np.testing.assert_allclose(
        float(s0.final_cost), float(s1.final_cost), rtol=1e-4
    )


def test_seg_sum_lm_scan_matches_segment_sum():
    """Both landmark-reduction forms (degree-class bucketed tables and
    the sorted-segmented-scan fallback) == jax.ops.segment_sum on a
    skewed id distribution, for [N, 3] and [N, 3, 3] operands."""
    rng = np.random.default_rng(1)
    N, L = 500, 17
    # skewed: landmark 3 owns half the observations; landmark 7 owns none
    ids = np.where(
        rng.random(N) < 0.5, 3, rng.integers(0, L, N)
    ).astype(np.int32)
    ids[ids == 7] = 2
    prob = graph_builder.synthetic_ba_problem(8, L, obs_per_kf=2, seed=0)[0]
    prob = prob._replace(
        obs_kf=np.zeros(N, np.int32), obs_lm=ids,
        obs_z=np.zeros((N, 3), np.float32),
        obs_w=np.zeros((N, 3, 3), np.float32),
        obs_valid=np.ones(N, bool),
    )
    tables = ba.build_tables(prob)
    assert tables.lm_bucket_tabs  # default tables carry the bucketed form
    scan_tables = tables._replace(lm_bucket_tabs=(), lm_rank=None)
    for shape in [(N, 3), (N, 3, 3)]:
        vals = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        want = jax.ops.segment_sum(vals, jnp.asarray(ids), num_segments=L)
        for t in (tables, scan_tables):
            got = ba._seg_sum_lm(vals, jnp.asarray(ids), L, t)
            np.testing.assert_allclose(
                np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-5
            )
