"""Equivalence of ekf.update_fused vs the sequential reference path.

The fused form is algebraically exact (same real-arithmetic result as the
sequential scan — see the update_fused docstring), so the two must agree to
f32 rounding on every state field, across known/new/invalid mixes, capacity
overflow, stationary gates, and divergence rejection.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aruco_slam_tpu.models import ekf
from aruco_slam_tpu.utils.config import CompatConfig, EkfConfig, SlamConfig


def random_state(rng, cfg, n_lm):
    max_lm = cfg.ekf.max_landmarks
    n = 3 + 3 * max_lm
    na = 3 + 3 * n_lm
    A = rng.normal(size=(na, na)) * 0.1
    sig_act = A @ A.T + 0.05 * np.eye(na)
    sigma = np.zeros((n, n), np.float32)
    sigma[:na, :na] = sig_act
    mu = np.zeros((n,), np.float32)
    mu[:na] = rng.normal(size=na)
    slot_ids = np.full((max_lm,), -1, np.int32)
    slot_ids[:n_lm] = rng.choice(1000, size=n_lm, replace=False)
    state = ekf.init_state(cfg)
    return state._replace(
        mu=jnp.asarray(mu),
        sigma=jnp.asarray(sigma),
        slot_ids=jnp.asarray(slot_ids),
        n_landmarks=jnp.asarray(n_lm, jnp.int32),
        last_obs=jnp.asarray(rng.normal(size=(max_lm, 3)).astype(np.float32)),
        seen_prev=jnp.asarray(rng.random(max_lm) < 0.5),
        initialized=jnp.ones((), bool),
    )


def random_frame(rng, cfg, state, n_known, n_new, n_invalid):
    m = cfg.ekf.max_observations_per_frame
    ids = np.full((m,), -1, np.int32)
    valid = np.zeros((m,), bool)
    n_lm = int(state.n_landmarks)
    known_ids = rng.choice(
        np.asarray(state.slot_ids[:n_lm]), size=min(n_known, n_lm), replace=False
    )
    new_ids = 2000 + rng.choice(1000, size=n_new, replace=False)
    use = list(known_ids) + list(new_ids)
    order = rng.permutation(m)
    for k, i in enumerate(use):
        ids[order[k]] = i
        valid[order[k]] = True
    # invalid slots keep garbage ids/z
    z = rng.normal(size=(m, 3)).astype(np.float32) * 0.5
    B = rng.normal(size=(m, 3, 3)).astype(np.float32) * 0.05
    R = B @ np.transpose(B, (0, 2, 1)) + 0.01 * np.eye(3, dtype=np.float32)
    return ekf.FrameObservations(
        ids=jnp.asarray(ids), z=jnp.asarray(z), R=jnp.asarray(R),
        valid=jnp.asarray(valid),
    )


def assert_states_close(s1, s2, atol):
    np.testing.assert_allclose(np.asarray(s1.mu), np.asarray(s2.mu), atol=atol)
    np.testing.assert_allclose(np.asarray(s1.sigma), np.asarray(s2.sigma), atol=atol)
    assert np.array_equal(np.asarray(s1.slot_ids), np.asarray(s2.slot_ids))
    assert int(s1.n_landmarks) == int(s2.n_landmarks)
    np.testing.assert_allclose(
        np.asarray(s1.last_obs), np.asarray(s2.last_obs), atol=atol
    )
    assert np.array_equal(np.asarray(s1.seen_prev), np.asarray(s2.seen_prev))
    assert int(s1.dropped) == int(s2.dropped)


@pytest.mark.parametrize("seed", range(6))
def test_fused_matches_sequential_mixed(seed):
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=12, max_observations_per_frame=8))
    rng = np.random.default_rng(seed)
    state = random_state(rng, cfg, n_lm=5)
    frame = random_frame(rng, cfg, state, n_known=3, n_new=2, n_invalid=3)
    s_seq = ekf.update(state, frame, cfg)
    s_fus = ekf.update_fused(state, frame, cfg)
    assert int(s_seq.diverged) == int(s_fus.diverged)
    assert_states_close(s_seq, s_fus, atol=5e-5)


def test_fused_capacity_overflow():
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=6, max_observations_per_frame=8))
    rng = np.random.default_rng(7)
    state = random_state(rng, cfg, n_lm=4)
    frame = random_frame(rng, cfg, state, n_known=2, n_new=5, n_invalid=1)
    s_seq = ekf.update(state, frame, cfg)
    s_fus = ekf.update_fused(state, frame, cfg)
    assert int(s_seq.dropped) == int(s_fus.dropped) > 0
    assert_states_close(s_seq, s_fus, atol=5e-5)


def test_fused_stationary_gate():
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=8, max_observations_per_frame=4))
    rng = np.random.default_rng(3)
    state = random_state(rng, cfg, n_lm=3)
    # Craft one observation identical to its last_obs with seen_prev set.
    sid = int(np.asarray(state.slot_ids)[1])
    state = state._replace(
        seen_prev=jnp.asarray(np.array([False, True, False] + [False] * 5)),
    )
    z1 = np.asarray(state.last_obs)[1]
    ids = np.array([sid, int(np.asarray(state.slot_ids)[0]), -1, -1], np.int32)
    z = np.stack([z1, rng.normal(size=3).astype(np.float32) * 0.3,
                  np.zeros(3, np.float32), np.zeros(3, np.float32)])
    R = np.broadcast_to(0.01 * np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    frame = ekf.FrameObservations(
        ids=jnp.asarray(ids), z=jnp.asarray(z), R=jnp.asarray(R),
        valid=jnp.asarray([True, True, False, False]),
    )
    s_seq = ekf.update(state, frame, cfg)
    s_fus = ekf.update_fused(state, frame, cfg)
    # the gated slot's last_obs must be zeroed in both paths
    assert np.allclose(np.asarray(s_seq.last_obs)[1], 0.0)
    assert_states_close(s_seq, s_fus, atol=5e-5)


@pytest.mark.parametrize("reject", [False, True])
def test_fused_divergence_modes(reject):
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=10, max_observations_per_frame=8),
        compat=CompatConfig(reject_divergent=reject, divergence_ze_norm=0.4),
    )
    rng = np.random.default_rng(11)
    state = random_state(rng, cfg, n_lm=6)
    frame = random_frame(rng, cfg, state, n_known=5, n_new=1, n_invalid=2)
    s_seq = ekf.update(state, frame, cfg)
    s_fus = ekf.update_fused(state, frame, cfg)
    assert int(s_seq.diverged) == int(s_fus.diverged)
    assert_states_close(s_seq, s_fus, atol=5e-5)


def test_fused_uninitialized_noop():
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=4))
    rng = np.random.default_rng(1)
    state = random_state(rng, cfg, n_lm=2)._replace(
        initialized=jnp.zeros((), bool)
    )
    frame = random_frame(rng, cfg, state, n_known=1, n_new=1, n_invalid=2)
    s_fus = ekf.update_fused(state, frame, cfg)
    assert np.array_equal(np.asarray(s_fus.mu), np.asarray(state.mu))
    assert int(s_fus.n_landmarks) == 2


def test_fused_multi_frame_replay_close():
    """Chained over many frames the two paths must stay numerically
    indistinguishable at trajectory level."""
    from aruco_slam_tpu import runner
    from aruco_slam_tpu.sim import synthetic

    cfg_seq = SlamConfig(ekf=EkfConfig(max_landmarks=24, max_observations_per_frame=8))
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=20.0, seed=5))
    data = runner.replay_data_from_sequence(seq, "obs")

    r_seq = runner.replay(data, cfg_seq, None, "obs")
    cfg_fus = SlamConfig(
        ekf=EkfConfig(max_landmarks=24, max_observations_per_frame=8, fused_update=True)
    )
    r_fus = runner.replay(data, cfg_fus, None, "obs")
    traj_d = np.max(np.abs(np.asarray(r_seq.trajectory) - np.asarray(r_fus.trajectory)))
    assert traj_d < 1e-3, traj_d
    assert int(r_seq.final_state.n_landmarks) == int(r_fus.final_state.n_landmarks)


def test_frame_update_for_auto_rule(monkeypatch):
    """Pin the backend policy measured on the GPU
    (benchmarks/gpu_kernel_policy.py): while the map fits the kernel's
    128 x 128 covariance tile, batched replay and the single stream take
    the Triton frame kernel; past it, batched replay takes the vmapped
    XLA scan and the single stream the fused block-LDL update. On the CPU
    everything takes the XLA scan. fused_update takes precedence, explicit
    backends are honored, and vmapped lanes always use the scan."""
    from aruco_slam_tpu import runner
    from aruco_slam_tpu.models import ekf
    from aruco_slam_tpu.ops.kernels import ekf_update_batched as kb

    def cfg(max_landmarks=8, **kw):
        return SlamConfig(ekf=EkfConfig(max_landmarks=max_landmarks, **kw))

    limit = runner.FRAME_KERNEL_MAX_LANDMARKS
    for backend in ("gpu", "cpu"):
        monkeypatch.setattr(runner.jax, "default_backend", lambda: backend)
        on_gpu = backend == "gpu"
        # fused_update wins regardless of backend/batched
        assert runner.frame_update_for(cfg(fused_update=True), False) is ekf.update_fused
        assert runner.frame_update_for(cfg(fused_update=True), True) is ekf.update_fused
        assert not runner.use_frame_kernel(cfg(fused_update=True))
        # vmapped lanes of the XLA replay: the scan
        assert runner.frame_update_for(cfg(), True) is ekf.update
        # auto: the kernel on a GPU up to the tile limit
        assert runner.use_frame_kernel(cfg()) is on_gpu
        assert runner.use_frame_kernel(cfg(limit)) is on_gpu
        assert not runner.use_frame_kernel(cfg(limit + 1))
        single = runner.frame_update_for(cfg(limit), False)
        assert single is (kb.frame_update if on_gpu else ekf.update)
        past = runner.frame_update_for(cfg(limit + 1), False)
        assert past is (ekf.update_fused if on_gpu else ekf.update)
        # explicit backends override the heuristic
        assert runner.use_frame_kernel(cfg(update_backend="triton"))
        assert runner.frame_update_for(cfg(update_backend="triton"), False) is kb.frame_update
        assert not runner.use_frame_kernel(cfg(update_backend="xla"))
        assert runner.frame_update_for(cfg(update_backend="xla"), False) is ekf.update
        assert runner.frame_update_for(cfg(limit + 1, update_backend="xla"), False) is ekf.update
        # explicit triton past the tile: a clear error, not a compile crash
        with pytest.raises(ValueError, match="tile"):
            runner.use_frame_kernel(cfg(limit + 1, update_backend="triton"))
        # one decision point: the single stream takes the kernel exactly
        # where batched replay does
        for kw in ({}, {"fused_update": True}, {"update_backend": "xla"},
                   {"update_backend": "triton"}):
            for lm in (limit, limit + 1):
                if lm > limit and kw.get("update_backend") == "triton":
                    continue
                c = cfg(lm, **kw)
                single = runner.frame_update_for(c, False)
                assert (single is kb.frame_update) is runner.use_frame_kernel(c)


def test_fused_update_rejects_triton_backend():
    """fused_update is an XLA update: asking for it together with the
    Triton backend is a config error, not a silent choice of one."""
    from aruco_slam_tpu.utils.config import ConfigError, load_config

    with pytest.raises(ConfigError, match="fused_update"):
        EkfConfig(fused_update=True, update_backend="triton")
    with pytest.raises(ConfigError, match="fused_update"):
        load_config({"ekf": {"fused_update": True, "update_backend": "triton"}})
    assert EkfConfig(fused_update=True, update_backend="xla").fused_update


@pytest.mark.parametrize("backend", ["pallas", "mosaic", "", "XLA"])
def test_unknown_update_backend_raises(backend):
    """update_backend accepts only "auto", "xla" and "triton"."""
    from aruco_slam_tpu.utils.config import ConfigError, load_config

    with pytest.raises(ConfigError, match="update_backend"):
        EkfConfig(update_backend=backend)
    with pytest.raises(ConfigError, match="update_backend"):
        load_config({"ekf": {"update_backend": backend}})
