"""Triton kernel parity tests, run in Pallas interpret mode on the CPU.
The compiled kernels are checked on the GPU by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aruco_slam_tpu import runner
from aruco_slam_tpu.models import ekf
from aruco_slam_tpu.ops import frontend
from aruco_slam_tpu.ops.camera import CameraIntrinsics
from aruco_slam_tpu.ops.kernels import ekf_update_batched as kb
from aruco_slam_tpu.ops.kernels import pnp_frontend as pk
from aruco_slam_tpu.sim import synthetic
from aruco_slam_tpu.utils.config import CompatConfig, EkfConfig, SlamConfig

CAM = CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
DISTORTED = CameraIntrinsics.create(
    600.0, 600.0, 320.0, 240.0, dist=[-0.28, 0.07, 1.2e-3, -8e-4, 0.018]
)


def _corner_seqs(n, cam=CAM, max_obs=4, duration=3.0, seed0=0):
    return [
        synthetic.generate_sequence(
            synthetic.SimParams(duration=duration, seed=seed0 + s,
                                max_obs=max_obs),
            level="corners", camera=cam,
        )
        for s in range(n)
    ]


def _assert_replays_match(out, ref, traj_atol=5e-5):
    np.testing.assert_allclose(
        np.asarray(out.trajectory), np.asarray(ref.trajectory),
        atol=traj_atol, rtol=5e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(out.n_landmarks), np.asarray(ref.n_landmarks)
    )
    np.testing.assert_allclose(
        np.asarray(out.final_state.sigma),
        np.asarray(ref.final_state.sigma), atol=5e-5, rtol=5e-3,
    )
    for name in ("slot_ids", "dropped", "diverged", "seen_prev"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out.final_state, name)),
            np.asarray(getattr(ref.final_state, name)),
        )
    np.testing.assert_allclose(
        np.asarray(out.final_state.last_obs),
        np.asarray(ref.final_state.last_obs), atol=5e-5,
    )


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("level", ["obs", "corners"])
def test_batched_frame_kernel_replay_matches_vmapped(level, batch):
    """The Triton replay (interpret mode) must reproduce the vmapped XLA
    replay over a full multi-frame sequence at observation and corner
    level: augmentation, gates, bookkeeping and capacity overflow
    (max_landmarks 3 is below the number of markers the run sees)."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=3, max_observations_per_frame=4))
    data = runner.build_batch_data(_corner_seqs(batch), batch, level)
    camera = CAM if level == "corners" else None
    ref = runner._replay_batch_jit(data, cfg, camera, level)
    out = runner._replay_batch_kernel(data, cfg, camera, level, interpret=True)
    _assert_replays_match(out, ref)
    assert int(np.asarray(ref.final_state.dropped).sum()) > 0


@pytest.mark.parametrize("cam", [CAM, DISTORTED], ids=["pinhole", "distorted"])
def test_pnp_frontend_kernel_matches_xla(cam):
    """The PnP front-end kernel must match the vmapped XLA
    observations_from_corners on a pinhole and on a realistically
    distorted calibration: same gates, z to ~1e-5, covariance to ~1e-6."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=8))
    (seq,) = _corner_seqs(1, cam, max_obs=8, duration=4.0, seed0=2)
    ids = jnp.asarray(seq.obs_ids[:5])
    corners = jnp.asarray(seq.corners_px[:5])
    valid = jnp.asarray(seq.obs_valid[:5])
    ref = jax.vmap(
        lambda i_, c_, v_: frontend.observations_from_corners(
            i_, c_, v_, cam, cfg
        )
    )(ids, corners, valid)
    out = pk.pnp_frontend_batch(ids, corners, valid, cam, cfg, interpret=True)
    vm = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(out.valid), vm)
    np.testing.assert_array_equal(np.asarray(out.ids), np.asarray(ids))
    np.testing.assert_allclose(np.asarray(out.z)[vm], np.asarray(ref.z)[vm], atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(out.R)[vm], np.asarray(ref.R)[vm], atol=2e-5, rtol=2e-4
    )


@pytest.mark.parametrize("batch", [1, 5, 37])
def test_pnp_frontend_kernel_block_tail(batch):
    """Pairs are cut into blocks of pk.BLOCK; the last block is ragged
    (37 x 4 = 148 pairs spans two blocks) and its masked lanes must not
    disturb the real ones. Invalid slots come back with valid = False."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=4))
    (seq,) = _corner_seqs(1, duration=4.0, seed0=4)
    reps = -(-batch // seq.num_frames)
    tile = lambda a: jnp.asarray(np.concatenate([a] * reps)[:batch])
    ids, corners, valid = tile(seq.obs_ids), tile(seq.corners_px), tile(seq.obs_valid)
    ref = jax.vmap(
        lambda i_, c_, v_: frontend.observations_from_corners(
            i_, c_, v_, CAM, cfg
        )
    )(ids, corners, valid)
    out = pk.pnp_frontend_batch(ids, corners, valid, CAM, cfg, interpret=True)
    assert out.z.shape == (batch, 4, 3) and out.R.shape == (batch, 4, 3, 3)
    vm = np.asarray(ref.valid)
    np.testing.assert_array_equal(np.asarray(out.valid), vm)
    assert not np.asarray(out.valid)[~np.asarray(valid)].any()
    np.testing.assert_allclose(np.asarray(out.z)[vm], np.asarray(ref.z)[vm], atol=2e-5)


@pytest.mark.parametrize("cam", [CAM, DISTORTED], ids=["pinhole", "distorted"])
def test_batched_frame_kernel_replay_camera_models(cam):
    """Corner-level kernel replay (PnP kernel + frame kernel) matches the
    vmapped replay on a pinhole and on a realistically distorted
    calibration (5-term Brown-Conrady, k1 = -0.28; reference
    src/aruco_slam_node.cpp:121-130 passes D straight from CameraInfo)."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=16, max_observations_per_frame=8))
    data = runner.build_batch_data(_corner_seqs(2, cam, max_obs=8), 2, "corners")
    ref = runner._replay_batch_jit(data, cfg, cam, "corners")
    out = runner._replay_batch_kernel(data, cfg, cam, "corners", interpret=True)
    _assert_replays_match(out, ref, traj_atol=1e-4)


CFG = SlamConfig(ekf=EkfConfig(max_landmarks=12, max_observations_per_frame=6))


def _mkframe(rng, ids, m=6):
    a = np.full(m, -1, np.int32)
    a[: len(ids)] = ids
    z = np.zeros((m, 3), np.float32)
    z[: len(ids)] = rng.uniform(0.3, 2, (len(ids), 3))
    R = np.tile(np.eye(3, dtype=np.float32) * 0.05, (m, 1, 1))
    v = np.zeros(m, bool)
    v[: len(ids)] = True
    return ekf.FrameObservations(
        jnp.asarray(a), jnp.asarray(z), jnp.asarray(R), jnp.asarray(v)
    )


def _run_single_stream(cfg, frames, rng, repeat_z=False):
    """(ekf.update, kernel frame_update) over the same frames, from a
    state initialized by a few encoder ticks. ``repeat_z`` re-sends each
    frame's measurements once so the stationary gate can fire."""
    state = ekf.init_state(cfg)._replace(initialized=jnp.ones((), bool))
    pred = jax.jit(ekf.predict, static_argnums=2)
    for _ in range(3):
        state = pred(
            state,
            ekf.Control(jnp.float32(1.2), jnp.float32(1.0), jnp.float32(0.05)),
            cfg,
        )
    upd = jax.jit(ekf.update, static_argnums=2)
    s_ref = s_ker = state
    for ids in frames:
        f = _mkframe(rng, ids)
        for _ in range(2 if repeat_z else 1):
            s_ref = upd(s_ref, f, cfg)
            s_ker = kb.frame_update(s_ker, f, cfg, interpret=True)
    return s_ref, s_ker


def _assert_state_equal(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a.mu), np.asarray(b.mu), atol=atol)
    np.testing.assert_allclose(np.asarray(a.sigma), np.asarray(b.sigma), atol=atol)
    assert int(a.n_landmarks) == int(b.n_landmarks)
    np.testing.assert_array_equal(np.asarray(a.slot_ids), np.asarray(b.slot_ids))
    np.testing.assert_array_equal(np.asarray(a.seen_prev), np.asarray(b.seen_prev))
    np.testing.assert_allclose(np.asarray(a.last_obs), np.asarray(b.last_obs), atol=atol)
    assert int(a.diverged) == int(b.diverged)
    assert int(a.dropped) == int(b.dropped)


def test_single_stream_frame_update_matches_xla(rng):
    """The kernel at batch 1 is a drop-in for ekf.update."""
    s_ref, s_ker = _run_single_stream(
        CFG, ([3, 5], [5, 9, 3], [9, 1], [1, 3, 5, 9]), rng
    )
    _assert_state_equal(s_ref, s_ker)


def test_single_stream_frame_update_capacity_overflow(rng):
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=2, max_observations_per_frame=6))
    s_ref, s_ker = _run_single_stream(cfg, ([1, 2, 3],), rng)
    _assert_state_equal(s_ref, s_ker)
    assert int(s_ker.dropped) == 1


@pytest.mark.parametrize(
    "compat",
    [CompatConfig(), CompatConfig(stationary_gate=False, reject_divergent=True)],
    ids=["reference", "gate_off_reject_divergent"],
)
def test_single_stream_frame_update_gates(rng, compat):
    """Stationary gate (a repeated measurement is skipped) and the
    divergence rejection match ekf.update."""
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=12, max_observations_per_frame=6),
        compat=compat,
    )
    s_ref, s_ker = _run_single_stream(
        cfg, ([2, 4], [4, 2], [2, 4, 6]), rng, repeat_z=True
    )
    _assert_state_equal(s_ref, s_ker)


@pytest.mark.parametrize("m_obs", [3, 6])
def test_single_stream_frame_update_stationary_start(rng, m_obs):
    """A robot that starts stationary (Qk = 0, so sigma stays exactly 0)
    with no marker in view: the observation rows the kernel pads up to a
    power of two, and the invalid ones, must stay inert on a singular pose
    covariance, as ekf.update skips them."""
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=m_obs)
    )
    state = ekf.init_state(cfg)._replace(initialized=jnp.ones((), bool))
    state = ekf.predict(
        state, ekf.Control(jnp.float32(0.0), jnp.float32(0.0),
                           jnp.float32(0.05)), cfg,
    )
    assert not np.asarray(state.sigma).any()
    s_ref = s_ker = state
    for ids in ([], [], [2], []):
        f = _mkframe(rng, ids, m=m_obs)
        s_ref = ekf.update(s_ref, f, cfg)
        s_ker = kb.frame_update(s_ker, f, cfg, interpret=True)
        assert np.isfinite(np.asarray(s_ker.sigma)).all()
        _assert_state_equal(s_ref, s_ker)


@pytest.mark.parametrize("level", ["obs", "corners"])
@pytest.mark.parametrize("m_obs", [3, 6])
def test_batched_frame_kernel_replay_stationary_start(level, m_obs):
    """Kernel replay vs the vmapped XLA replay when every sequence starts
    stationary with no marker in view for its first frames, at a number
    of observations per frame that is not a power of two (the kernel pads
    rows); then it drives, sees markers and fills its map."""
    cfg = SlamConfig(
        ekf=EkfConfig(max_landmarks=4, max_observations_per_frame=m_obs)
    )
    data = runner.build_batch_data(_corner_seqs(2, max_obs=m_obs), 2, level)
    still = 5
    data = data._replace(
        enc_w=data.enc_w.at[:, :still].set(0.0),
        obs_valid=data.obs_valid.at[:, :still].set(False),
    )
    camera = CAM if level == "corners" else None
    ref = runner._replay_batch_jit(data, cfg, camera, level)
    out = runner._replay_batch_kernel(data, cfg, camera, level, interpret=True)
    assert np.isfinite(np.asarray(out.final_state.sigma)).all()
    _assert_replays_match(out, ref)
    assert int(np.asarray(ref.final_state.n_landmarks).min()) > 0


def test_single_stream_frame_update_uninitialized_noop(rng):
    """No encoder tick yet: the frame is ignored (reference addImage
    early-out)."""
    state = ekf.init_state(CFG)  # initialized=False
    out = kb.frame_update(state, _mkframe(rng, [3]), CFG, interpret=True)
    np.testing.assert_allclose(np.asarray(out.mu), 0.0)
    assert int(out.n_landmarks) == 0
    assert not bool(out.initialized)


def test_batched_kernels_lane_invariant_to_batch_size():
    """A sequence's replay must not depend on how many other sequences
    ride in the batch: frame programs are independent (one per sequence)
    and the PnP blocks mix sequences, so tiling the batch 3x must
    reproduce every sequence's result exactly."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=8, max_observations_per_frame=4))
    seqs = _corner_seqs(2)
    small = runner.build_batch_data(seqs, 2, "corners")
    big = runner.build_batch_data(seqs, 6, "corners")  # 3x tiled
    out_s = runner._replay_batch_kernel(small, cfg, CAM, "corners", interpret=True)
    out_b = runner._replay_batch_kernel(big, cfg, CAM, "corners", interpret=True)
    for k in range(3):
        np.testing.assert_array_equal(
            np.asarray(out_b.trajectory)[2 * k: 2 * k + 2],
            np.asarray(out_s.trajectory),
        )
    np.testing.assert_array_equal(
        np.asarray(out_b.n_landmarks)[:2], np.asarray(out_s.n_landmarks)
    )
    np.testing.assert_array_equal(
        np.asarray(out_b.final_state.sigma)[:2],
        np.asarray(out_s.final_state.sigma),
    )


@pytest.mark.parametrize(
    "max_lm,expect", [(1, (8, 1)), (8, (32, 8)), (32, (128, 32)), (41, (128, 64))]
)
def test_frame_kernel_padded_dims(max_lm, expect):
    """The covariance tile is the next power of two of N = 3 + 3 L; the
    slot table the next power of two of L. The policy's landmark limit is
    the largest map whose tile is 128 x 128."""
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=max_lm))
    assert kb.padded_dims(cfg) == expect
    limit = SlamConfig(
        ekf=EkfConfig(max_landmarks=runner.FRAME_KERNEL_MAX_LANDMARKS)
    )
    assert kb.padded_dims(limit)[0] == 128
    past = SlamConfig(
        ekf=EkfConfig(max_landmarks=runner.FRAME_KERNEL_MAX_LANDMARKS + 1)
    )
    assert kb.padded_dims(past)[0] == 256
