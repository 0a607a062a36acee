"""Pallas kernel (Triton route): the EKF frame step for a whole replay
batch in one launch, one program per sequence; at batch 1 it is also the
single-stream frame update (:func:`frame_update`).

Why: the vmapped XLA frame step (``ekf.predict_block`` + ``ekf.update``
under ``vmap`` inside the replay ``lax.scan``) is hundreds of tiny kernels
per frame, each paying a launch. Here each program holds its sequence's
covariance as one power-of-two register tile (``128 x 128`` for
``N = 3 + 3 * 32``) across the frame's whole sequential observation chain,
so a frame costs one launch and the covariance is read and written once.

Semantics are those of ``ekf.predict_block`` followed by ``ekf.update``
(stale linearization mean, observation order sorted outside, stationary
and divergence gates, landmark augmentation, bookkeeping). The per-frame
``[3, 3]`` predict composition (A, Q) and the pose mean integration run
outside in XLA (``ekf.predict_compose``); the kernel applies the
covariance transform and the observation chain. Column reads and slot
writes are iota masks, and nothing is gathered. All arithmetic is
elementwise float32 with no ``pl.dot``, so TF32 never enters the
covariance algebra.

State layout (batch leading, padded to powers of two; padding is exactly
zero and never read back): ``mu [B, NP]``, ``sigma [B, NP, NP]``,
``slot_ids [B, LP]``, ``last_obs [B, LP, 4]``, ``seen [B, LP]`` and
``counts [B, 4]`` (n_landmarks, diverged, dropped, unused).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from aruco_slam_tpu.models import ekf
from aruco_slam_tpu.utils.config import SlamConfig

Array = jax.Array

# Column layout of the packed per-frame inputs.
PRED_WIDTH = 32  # pose (3), A (9), Q (9), zero padding
OBS_F_WIDTH = 16  # z (3), R row-major (9), zero padding
OBS_I_WIDTH = 4  # id, frame-start slot, valid, unused


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def padded_dims(config: SlamConfig) -> tuple[int, int]:
    """(NP, LP): the power-of-two state and slot widths of the tile."""
    max_lm = config.ekf.max_landmarks
    return _next_pow2(3 + 3 * max_lm), _next_pow2(max_lm)


def _wrap(a):
    two_pi = 2.0 * jnp.pi
    a = jnp.where(a >= jnp.pi, a - two_pi, a)
    return jnp.where(a < -jnp.pi, a + two_pi, a)


def _inv3(S):
    """Closed-form 3x3 inverse of a matrix given as nested lists of
    scalars."""
    a, b, c = S[0]
    d, e, f = S[1]
    g, h, i = S[2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    inv_det = 1.0 / (a * co_a + b * co_b + c * co_c)
    return [
        [co_a * inv_det, -(b * i - c * h) * inv_det, (b * f - c * e) * inv_det],
        [co_b * inv_det, (a * i - c * g) * inv_det, -(a * f - c * d) * inv_det],
        [co_c * inv_det, -(a * h - b * g) * inv_det, (a * e - b * d) * inv_det],
    ]


def _mat3_mul(X, Y):
    return [
        [sum(X[i][k] * Y[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _mat3_T(X):
    return [[X[j][i] for j in range(3)] for i in range(3)]


def _frame_kernel(
    mu_ref, sig_ref, slot_ref, last_ref, seen_ref, cnt_ref,
    pred_ref, obf_ref, obi_ref,
    mu_out, sig_out, slot_out, last_out, seen_out, cnt_out,
    *, config: SlamConfig, m_obs: int,
):
    cfg = config
    max_lm = cfg.ekf.max_landmarks
    n_p = mu_ref.shape[0]
    l_p = slot_ref.shape[0]
    f32 = jnp.float32

    iota_n = jax.lax.broadcasted_iota(jnp.int32, (n_p,), 0)
    row_i = jax.lax.broadcasted_iota(jnp.int32, (n_p, n_p), 0)
    col_i = jax.lax.broadcasted_iota(jnp.int32, (n_p, n_p), 1)
    iota_lm = jax.lax.broadcasted_iota(jnp.int32, (l_p,), 0)

    def row(s, k):
        return jnp.sum(jnp.where(row_i == k, s, 0.0), axis=0)

    def col(s, k):
        return jnp.sum(jnp.where(col_i == k, s, 0.0), axis=1)

    def elem(v, k):
        return jnp.sum(jnp.where(iota_n == k, v, 0.0))

    # ---------------- predict: sigma <- A~ sigma A~^T + Q~ ---------------
    pose = [pred_ref[k] for k in range(3)]
    A = [[pred_ref[3 + 3 * i + j] for j in range(3)] for i in range(3)]
    Q = [[pred_ref[12 + 3 * i + j] for j in range(3)] for i in range(3)]
    sigma = sig_ref[...]
    rows = [row(sigma, k) for k in range(3)]
    for i in range(3):
        new_row = sum(A[i][k] * rows[k] for k in range(3))
        sigma = jnp.where(row_i == i, new_row[None, :], sigma)
    cols = [col(sigma, k) for k in range(3)]
    for j in range(3):
        q_col = sum(jnp.where(iota_n == i, Q[i][j], 0.0) for i in range(3))
        new_col = sum(cols[k] * A[j][k] for k in range(3)) + q_col
        sigma = jnp.where(col_i == j, new_col[:, None], sigma)
    mu = mu_ref[...]
    for i in range(3):
        mu = jnp.where(iota_n == i, pose[i], mu)

    mu0 = mu  # stale linearization mean (src/aruco_slam.cpp:88)
    x0, y0, th0 = pose
    sth = jnp.sin(th0)
    cth = jnp.cos(th0)
    zero = jnp.zeros_like(cth)
    one = jnp.ones_like(cth)
    Gl = [[cth, sth, zero], [-sth, cth, zero], [zero, zero, one]]

    frozen_last = [last_ref[:, a] for a in range(3)]  # [LP] each
    frozen_seen = seen_ref[...] != 0

    def obs_step(i, carry):
        (mu, sigma, slot_ids, n_lm, nl0, nl1, nl2, new_seen, diverged,
         dropped) = carry
        new_last = [nl0, nl1, nl2]
        ob_id = obi_ref[i, 0]
        slot = obi_ref[i, 1]
        valid = obi_ref[i, 2] != 0
        z = [obf_ref[i, a] for a in range(3)]
        Rk = [[obf_ref[i, 3 + 3 * a + b] for b in range(3)] for a in range(3)]

        is_known = slot >= 0
        has_room = n_lm < max_lm
        eff = jnp.where(is_known, slot, n_lm)
        idx = 3 + 3 * eff
        oh = [jnp.where(iota_n == idx + r, 1.0, 0.0) for r in range(3)]
        sel = iota_lm == eff

        # ---------------- known-landmark branch --------------------------
        m_r = [jnp.sum(oh[r] * mu0) for r in range(3)]
        gdx = m_r[0] - x0
        gdy = m_r[1] - y0
        gdth = _wrap(m_r[2] - th0)
        zh0 = gdx * cth + gdy * sth
        zh1 = -gdx * sth + gdy * cth
        ze = [z[0] - zh0, z[1] - zh1, _wrap(z[2] - gdth)]
        Gp = [
            [-cth, -sth, -gdx * sth + gdy * cth],
            [sth, -cth, -gdx * cth - gdy * sth],
            [zero, zero, -one],
        ]
        sig_pose = [row(sigma, k) for k in range(3)]
        sig_lm = [jnp.sum(oh[r][:, None] * sigma, axis=0) for r in range(3)]
        Bm = [
            sum(Gp[k][kk] * sig_pose[kk] for kk in range(3))
            + sum(Gl[k][kk] * sig_lm[kk] for kk in range(3))
            for k in range(3)
        ]  # rows of B = Gx sigma
        # S = B[:, :3] Gp^T + (B E^T) Gl^T + R
        Bp = [[elem(Bm[a], kk) for kk in range(3)] for a in range(3)]
        BE = [[jnp.sum(Bm[a] * oh[r]) for r in range(3)] for a in range(3)]
        S = [
            [
                sum(Bp[a][kk] * Gp[b][kk] for kk in range(3))
                + sum(BE[a][r] * Gl[b][r] for r in range(3))
                + Rk[a][b]
                for b in range(3)
            ]
            for a in range(3)
        ]
        invS = _inv3(S)
        KT = [sum(invS[a][b] * Bm[b] for b in range(3)) for a in range(3)]

        k_norm2 = sum(jnp.sum(KT[a] * KT[a]) for a in range(3))
        ze_norm2 = sum(ze[a] * ze[a] for a in range(3))
        div_hit = (ze_norm2 >= cfg.compat.divergence_ze_norm ** 2) | (
            k_norm2 >= cfg.compat.divergence_k_norm ** 2
        )
        do_known = valid & is_known
        do_new = valid & jnp.logical_not(is_known) & has_room
        do_drop = valid & jnp.logical_not(is_known) & jnp.logical_not(has_room)
        # keep_z: a known observation not stopped by the stationary gate
        keep_z = do_known
        if cfg.compat.stationary_gate:
            seen_p = jnp.sum(jnp.where(sel & frozen_seen, 1, 0)) > 0
            last_p = [
                jnp.sum(jnp.where(sel, frozen_last[a], 0.0)) for a in range(3)
            ]
            d2 = sum((last_p[a] - z[a]) ** 2 for a in range(3))
            gate = seen_p & (d2 < cfg.compat.stationary_gate_eps ** 2)
            keep_z = do_known & jnp.logical_not(gate)
        apply_known = keep_z
        if cfg.compat.reject_divergent:
            apply_known = keep_z & jnp.logical_not(div_hit)
        mk = apply_known.astype(f32)
        mn = do_new.astype(f32)

        # ---------------- new-landmark branch ----------------------------
        map_x = x0 + cth * z[0] - sth * z[1]
        map_y = y0 + sth * z[0] + cth * z[1]
        map_r = [map_x, map_y, _wrap(th0 + z[2])]
        mu = (
            mu
            + sum((mk * ze[a]) * KT[a] for a in range(3))
            + sum((mn * map_r[r]) * oh[r] for r in range(3))
        )
        dxn = map_x - x0
        dyn = map_y - y0
        Gsk = [
            [-cth, -sth, -sth * dxn + cth * dyn],
            [sth, -cth, -dxn * cth - dyn * sth],
            [zero, zero, -one],
        ]
        sig3 = [[elem(sig_pose[a], b) for b in range(3)] for a in range(3)]
        inner = _mat3_mul(_mat3_mul(Gsk, sig3), _mat3_T(Gsk))
        inner = [[inner[a][b] + Rk[a][b] for b in range(3)] for a in range(3)]
        smm = _mat3_mul(_mat3_mul(Gl, _mat3_T(inner)), _mat3_T(Gl))
        GmiGsk = _mat3_mul(Gl, Gsk)
        smx = [
            -sum(GmiGsk[r][kk] * sig_pose[kk] for kk in range(3))
            for r in range(3)
        ]  # rows of sigma_mx
        # known rank-3 correction + new-landmark augmentation in one pass;
        # u_r = smx_r + 0.5 sum_r' smm[r, r'] oh_r' (smm symmetric)
        upd = sum((mk * KT[a])[:, None] * Bm[a][None, :] for a in range(3))
        for r in range(3):
            u_r = smx[r] + 0.5 * sum(smm[r][rr] * oh[rr] for rr in range(3))
            upd = upd - (mn * oh[r])[:, None] * u_r[None, :]
            upd = upd - (mn * u_r)[:, None] * oh[r][None, :]
        sigma = sigma - upd

        # ---------------- bookkeeping ------------------------------------
        slot_ids = jnp.where(do_new & sel, ob_id, slot_ids)
        n_lm = n_lm + do_new.astype(jnp.int32)
        write_mask = (do_known | do_new) & sel
        new_last = [
            jnp.where(write_mask, jnp.where(keep_z, z[a], 0.0), new_last[a])
            for a in range(3)
        ]
        new_seen = jnp.where(write_mask, 1, new_seen)
        diverged = diverged + (do_known & div_hit).astype(jnp.int32)
        dropped = dropped + do_drop.astype(jnp.int32)
        return (mu, sigma, slot_ids, n_lm, *new_last, new_seen, diverged,
                dropped)

    carry = (
        mu, sigma, slot_ref[...], cnt_ref[0], *frozen_last,
        jnp.zeros((l_p,), jnp.int32), cnt_ref[1], cnt_ref[2],
    )
    (mu, sigma, slot_ids, n_lm, nl0, nl1, nl2, new_seen, diverged,
     dropped) = jax.lax.fori_loop(0, m_obs, obs_step, carry)

    if cfg.ekf.symmetrize_sigma:
        sigma = 0.5 * (sigma + sigma.T)
    mu_out[...] = mu
    sig_out[...] = sigma
    slot_out[...] = slot_ids
    for a, v in enumerate((nl0, nl1, nl2)):
        last_out[:, a] = v
    seen_out[...] = new_seen
    cnt_out[0] = n_lm
    cnt_out[1] = diverged
    cnt_out[2] = dropped


def init_state(batch: int, config: SlamConfig) -> dict:
    """Fresh padded kernel state (``ekf.init_state`` for ``batch``
    sequences)."""
    return from_ekf_state(
        jax.vmap(lambda _: ekf.init_state(config))(jnp.arange(batch)), config
    )


def from_ekf_state(state: ekf.EkfState, config: SlamConfig) -> dict:
    """Batched ``EkfState`` (leading batch axis) -> padded kernel state."""
    n_p, l_p = padded_dims(config)
    n = state.mu.shape[1]
    max_lm = config.ekf.max_landmarks
    pad_lm = ((0, 0), (0, l_p - max_lm))
    return dict(
        mu=jnp.pad(state.mu, ((0, 0), (0, n_p - n))),
        sigma=jnp.pad(state.sigma, ((0, 0), (0, n_p - n), (0, n_p - n))),
        slot_ids=jnp.pad(state.slot_ids, pad_lm, constant_values=-1),
        last_obs=jnp.pad(state.last_obs, pad_lm + ((0, 1),)),
        seen=jnp.pad(state.seen_prev.astype(jnp.int32), pad_lm),
        counts=jnp.stack(
            [state.n_landmarks, state.diverged, state.dropped,
             jnp.zeros_like(state.dropped)], axis=1,
        ),
    )


def to_ekf_state(st: dict, config: SlamConfig) -> ekf.EkfState:
    """Padded kernel state -> batched ``EkfState`` (after a predict, so
    ``initialized`` is set)."""
    max_lm = config.ekf.max_landmarks
    n = 3 + 3 * max_lm
    return ekf.EkfState(
        mu=st["mu"][:, :n],
        sigma=st["sigma"][:, :n, :n],
        slot_ids=st["slot_ids"][:, :max_lm],
        n_landmarks=st["counts"][:, 0],
        last_obs=st["last_obs"][:, :max_lm, :3],
        seen_prev=st["seen"][:, :max_lm] != 0,
        initialized=jnp.ones(st["mu"].shape[:1], bool),
        diverged=st["counts"][:, 1],
        dropped=st["counts"][:, 2],
    )


def pack_frame(slot_ids, pose, A, Q, frame: ekf.FrameObservations):
    """Per-frame kernel inputs for a batch: ``slot_ids [B, LP]`` is the
    frame-start slot table, ``pose [B, 3]``, ``A``/``Q`` ``[B, 3, 3]`` the
    composed predict, ``frame`` fields ``[B, M, ...]``. Observations are
    sorted in the reference's order (``ekf.update``) and padded to a
    power-of-two M. Returns (pred, obs_f, obs_i)."""
    batch, m_obs = frame.ids.shape
    m_p = _next_pow2(m_obs)
    f32 = jnp.float32
    slots = jax.vmap(ekf.lookup_slots)(slot_ids, frame.ids)
    arrival = jnp.arange(m_obs, dtype=jnp.int32)
    big = jnp.asarray(2_000_000_000, jnp.int32)
    key = jnp.where(frame.valid, slots * m_obs + arrival[None, :], big)
    perm = jnp.argsort(key, axis=1)

    def take(a):
        idx = perm.reshape(perm.shape + (1,) * (a.ndim - 2))
        return jnp.take_along_axis(a, idx, axis=1)

    # Invalid and padding rows are computed masked in the kernel: give
    # them z = 0, R = I and slot -1, so their innovation covariance stays
    # invertible (a zero pose covariance, as at a stationary start, would
    # make S singular) and no inf or NaN (e.g. PnP on padded corners)
    # leaks through 0 * NaN.
    pad_m = ((0, 0), (0, m_p - m_obs))
    valid = jnp.pad(take(frame.valid), pad_m)
    ok = valid[..., None]
    z = jnp.where(ok, jnp.pad(take(frame.z.astype(f32)), pad_m + ((0, 0),)),
                  0.0)
    R = jnp.where(
        ok,
        jnp.pad(take(frame.R.astype(f32).reshape(batch, m_obs, 9)),
                pad_m + ((0, 0),)),
        jnp.eye(3, dtype=f32).reshape(9),
    )
    slot = jnp.where(valid, jnp.pad(take(slots), pad_m), -1)
    ids = jnp.pad(take(frame.ids), pad_m, constant_values=-1)
    pred = jnp.concatenate(
        [pose.astype(f32), A.reshape(batch, 9).astype(f32),
         Q.reshape(batch, 9).astype(f32),
         jnp.zeros((batch, PRED_WIDTH - 21), f32)], axis=1,
    )
    obs_f = jnp.concatenate(
        [z, R, jnp.zeros((batch, m_p, OBS_F_WIDTH - 12), f32)], axis=2,
    )
    obs_i = jnp.stack(
        [ids, slot, valid.astype(jnp.int32),
         jnp.zeros((batch, m_p), jnp.int32)], axis=2,
    )
    return pred, obs_f, obs_i


def frame_update(
    state: ekf.EkfState,
    frame: ekf.FrameObservations,
    config: SlamConfig,
    interpret: bool = False,
) -> ekf.EkfState:
    """Drop-in for ``ekf.update`` (one stream): the frame kernel at batch
    1 with an identity predict."""
    def run(state):
        st = from_ekf_state(jax.tree.map(lambda x: x[None], state), config)
        eye = jnp.eye(3, dtype=jnp.float32)[None]
        pred, obs_f, obs_i = pack_frame(
            st["slot_ids"], state.mu[None, :3], eye, 0.0 * eye,
            jax.tree.map(lambda x: x[None], frame),
        )
        st = frame_step(st, pred, obs_f, obs_i, config, interpret=interpret)
        return jax.tree.map(lambda x: x[0], to_ekf_state(st, config))

    # no encoder tick yet: the reference's addImage early-out
    return jax.lax.cond(state.initialized, run, lambda s: s, state)


_STATE_KEYS = ("mu", "sigma", "slot_ids", "last_obs", "seen", "counts")


@functools.partial(jax.jit, static_argnames=("config", "interpret"))
def frame_step(
    state: dict,
    pred: Array,  # [B, PRED_WIDTH] pose, A, Q (see PRED_WIDTH)
    obs_f: Array,  # [B, MP, OBS_F_WIDTH] sorted z, R
    obs_i: Array,  # [B, MP, OBS_I_WIDTH] sorted id, slot, valid
    config: SlamConfig,
    interpret: bool = False,
) -> dict:
    """One EKF frame step (covariance predict + sequential observation
    updates) for every sequence of the batch in one launch. ``MP`` must be
    a power of two; rows past the frame's observations carry valid = 0."""
    batch, n_p = state["mu"].shape
    l_p = state["slot_ids"].shape[1]
    m_p = obs_f.shape[1]
    specs = dict(
        mu=pl.BlockSpec((None, n_p), lambda b: (b, 0)),
        sigma=pl.BlockSpec((None, n_p, n_p), lambda b: (b, 0, 0)),
        slot_ids=pl.BlockSpec((None, l_p), lambda b: (b, 0)),
        last_obs=pl.BlockSpec((None, l_p, 4), lambda b: (b, 0, 0)),
        seen=pl.BlockSpec((None, l_p), lambda b: (b, 0)),
        counts=pl.BlockSpec((None, 4), lambda b: (b, 0)),
    )
    in_specs = [specs[k] for k in _STATE_KEYS] + [
        pl.BlockSpec((None, PRED_WIDTH), lambda b: (b, 0)),
        pl.BlockSpec((None, m_p, OBS_F_WIDTH), lambda b: (b, 0, 0)),
        pl.BlockSpec((None, m_p, OBS_I_WIDTH), lambda b: (b, 0, 0)),
    ]
    outs = pl.pallas_call(
        functools.partial(_frame_kernel, config=config, m_obs=m_p),
        out_shape=tuple(
            jax.ShapeDtypeStruct(state[k].shape, state[k].dtype)
            for k in _STATE_KEYS
        ),
        grid=(batch,),
        in_specs=in_specs,
        out_specs=tuple(specs[k] for k in _STATE_KEYS),
        input_output_aliases={i: i for i in range(len(_STATE_KEYS))},
        compiler_params=plgpu.CompilerParams(
            num_warps=max(4, min(16, n_p * n_p // 2048)), num_stages=1
        ),
        interpret=interpret,
        name="ekf_frame_step",
    )(*(state[k] for k in _STATE_KEYS), pred, obs_f, obs_i)
    return dict(zip(_STATE_KEYS, outs))
