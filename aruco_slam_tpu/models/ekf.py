"""EKF-SLAM core (L1) — a JAX re-design of the reference estimator.

Reimplements the joint pose+landmark EKF of ``ArucoSlam`` (reference
src/aruco_slam.cpp): *predict* from differential-drive encoders
(``addEncoder``, :12-74) and sequential per-marker *update* with online
landmark augmentation (``addImage``, :76-287) — for static-shape XLA:

- **Fixed-capacity masked state.** The reference grows ``mu_``/``sigma_``
  dynamically (src/aruco_slam.cpp:215-225,246-253); XLA needs static shapes,
  so the state is pre-allocated for ``max_landmarks`` slots with an active
  count. Inactive rows/columns are exactly zero, which leaves the Kalman
  gain and covariance updates bit-identical to the growing-matrix math
  (zero rows of sigma produce zero gain rows).
- **Sequential updates under ``lax.scan``.** The reference's per-marker
  while-loop (ascending map index, new markers first — the inverted
  ``ArucoMarker::operator<`` at aruco_slam.h:85-88) becomes a scan over a
  sorted, masked observation batch, preserving the order-dependent
  semantics including the *stale linearization point*: all ``z_hat`` and
  Jacobians use the frame-start mean (``Eigen::MatrixXd mu = mu_`` at
  src/aruco_slam.cpp:88) while corrections accumulate into the live mean.
- **Structured covariance algebra.** Rather than forming the N x N
  ``Hx``/``F`` selector matrices (src/aruco_slam.cpp:64-73,112-116), the
  predict touches only the 3 pose rows/cols and the update uses the 6
  nonzero observation-Jacobian columns, turning the O(N^3)-ish dense
  products into O(N) row/col updates and one rank-3 N x N correction.

All reference quirks are reproduced or gated per SURVEY.md section 7.1 via
``CompatConfig``; see the inline notes.

Everything here is pure: ``(state, input) -> state``; jit/vmap/scan safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from aruco_slam_tpu.ops import geometry, linalg
from aruco_slam_tpu.utils.config import SlamConfig

Array = jax.Array


class EkfState(NamedTuple):
    """Joint Gaussian over (pose, landmarks) plus bookkeeping.

    Mirrors the reference members ``mu_``/``sigma_``/``aruco_id_map``/
    ``last_observed_marker_`` (aruco_slam.h:164,182-188) as fixed-shape
    arrays. ``N = 3 + 3 * max_landmarks``.
    """

    mu: Array  # [N] mean: (x, y, theta, m1x, m1y, m1th, ...)
    sigma: Array  # [N, N] covariance; inactive rows/cols are zero
    slot_ids: Array  # [max_lm] int32 marker id per slot, -1 if empty
    n_landmarks: Array  # [] int32 active landmark count
    last_obs: Array  # [max_lm, 3] last accepted measurement per slot
    seen_prev: Array  # [max_lm] bool: processed in the previous frame
    initialized: Array  # [] bool: first-encoder latch (is_init_, :24-29)
    diverged: Array  # [] int32: count of log-only divergence hits (:156-175)
    dropped: Array  # [] int32: observations dropped (capacity / rejection)


class FrameObservations(NamedTuple):
    """One image frame's marker observations, padded to a static width.

    Produced by the vision front-end (detection + PnP + gating); the EKF
    only sees ``(id, z, R, valid)`` — the same seam as the reference's
    ``obs_`` queue (aruco_slam.h:190).
    """

    ids: Array  # [M] int32 marker ids (-1 for padding)
    z: Array  # [M, 3] measurements (x, y, theta) in robot frame
    R: Array  # [M, 3, 3] observation covariances
    valid: Array  # [M] bool


class Control(NamedTuple):
    """One encoder tick: wheel angular velocities + integration interval.

    The reference uses wall-clock receive time for dt (src/aruco_slam.cpp:31
    — quirk (a)); we take dt from data timestamps for deterministic replay.
    """

    wl: Array
    wr: Array
    dt: Array


def init_state(config: SlamConfig, dtype=jnp.float32) -> EkfState:
    """Fresh state: 3-dof pose at origin with zero covariance
    (reference ctor, src/aruco_slam.cpp:13-16)."""
    max_lm = config.ekf.max_landmarks
    n = 3 + 3 * max_lm
    return EkfState(
        mu=jnp.zeros((n,), dtype),
        sigma=jnp.zeros((n, n), dtype),
        slot_ids=jnp.full((max_lm,), -1, jnp.int32),
        n_landmarks=jnp.zeros((), jnp.int32),
        last_obs=jnp.zeros((max_lm, 3), dtype),
        seen_prev=jnp.zeros((max_lm,), bool),
        initialized=jnp.zeros((), bool),
        diverged=jnp.zeros((), jnp.int32),
        dropped=jnp.zeros((), jnp.int32),
    )


# ---------------------------------------------------------------------------
# Predict (reference addEncoder, src/aruco_slam.cpp:21-74)
# ---------------------------------------------------------------------------


def predict(state: EkfState, control: Control, config: SlamConfig) -> EkfState:
    """EKF predict from one encoder tick.

    Mean: midpoint-arc differential-drive model (src/aruco_slam.cpp:35-52).
    Covariance: sigma <- Hx sigma Hx^T + F Qk F^T (src/aruco_slam.cpp:55-73),
    computed structurally — Hx differs from identity only in the top-left
    3x3, so only 3 rows + 3 cols of sigma are touched.
    """
    odom = config.odom
    cov = config.covariance
    wl, wr, dt = control.wl, control.wr, control.dt

    delta_sl = odom.kl * dt * wl
    delta_sr = odom.kr * dt * wr
    delta_theta = (delta_sr - delta_sl) / (2.0 * odom.b)
    delta_s = 0.5 * (delta_sr + delta_sl)

    tmp_th = state.mu[2] + 0.5 * delta_theta
    c, s = jnp.cos(tmp_th), jnp.sin(tmp_th)

    new_pose = jnp.stack(
        [
            state.mu[0] + delta_s * c,
            state.mu[1] + delta_s * s,
            geometry.wrap_angle(state.mu[2] + delta_theta),
        ]
    )
    mu = state.mu.at[:3].set(new_pose)

    # Pose Jacobian H_xi (src/aruco_slam.cpp:55-58)
    dtype = state.mu.dtype
    H_xi = jnp.asarray(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype
    )
    H_xi = H_xi.at[0, 2].set(-delta_s * s).at[1, 2].set(delta_s * c)

    # Control-noise Jacobian. Quirk (b): the reference scales BOTH columns
    # by kl (src/aruco_slam.cpp:60-62); the corrected form uses kl and kr.
    if config.compat.process_noise_uses_kl_for_both_wheels:
        wkh = (0.5 * odom.kl * dt) * jnp.stack(
            [
                jnp.stack([c, c]),
                jnp.stack([s, s]),
                jnp.stack([1.0 / odom.b, -1.0 / odom.b]),
            ]
        )
    else:
        half_dt = 0.5 * dt
        wkh = half_dt * jnp.stack(
            [
                jnp.stack([odom.kl * c, odom.kr * c]),
                jnp.stack([odom.kl * s, odom.kr * s]),
                jnp.stack([odom.kl / odom.b, -odom.kr / odom.b]),
            ]
        )
    sigma_u = jnp.diag(jnp.stack([cov.Q_k * jnp.abs(wl), cov.Q_k * jnp.abs(wr)]))
    Qk = wkh @ sigma_u @ wkh.T  # 3x3

    # sigma <- Hx sigma Hx^T + blockdiag(Qk, 0): only rows/cols 0..2 change.
    sigma = state.sigma
    sigma = sigma.at[:3, :].set(H_xi @ sigma[:3, :])
    sigma = sigma.at[:, :3].set(sigma[:, :3] @ H_xi.T)
    sigma = sigma.at[:3, :3].add(Qk.astype(dtype))

    # First-encoder latch (src/aruco_slam.cpp:24-29): the reference only
    # records the time and integrates nothing. We model it by gating the
    # whole effect on `initialized`.
    mu = jnp.where(state.initialized, mu, state.mu)
    sigma = jnp.where(state.initialized, sigma, state.sigma)
    return state._replace(
        mu=mu, sigma=sigma, initialized=jnp.ones((), bool)
    )


def predict_block(state: EkfState, controls: Control, config: SlamConfig) -> EkfState:
    """Fused predict over a block of encoder ticks (e.g. all ticks between
    two camera frames).

    Algebraically identical to folding :func:`predict` over the ticks: every
    per-tick ``Hx`` is identity outside the pose block and ``Qk`` adds only
    into it, so the composition stays a 3x3 pair —

        A <- H_k A,   Q <- H_k Q H_k^T + Qk_k

    accumulated by a cheap 3-vector/3x3 ``lax.scan``, after which the big
    [N, N] covariance is touched ONCE (rows' = A sigma[0:3,:], symmetric
    cols, + Q) instead of once per tick — a ~tick-count reduction in sigma
    traffic for the replay hot loop.

    The first-encoder latch consumes the first tick of the first block, as
    in :func:`predict` (reference src/aruco_slam.cpp:24-29).
    """
    pose, A, Q = predict_compose(
        state.mu[:3], state.initialized, controls, config
    )
    mu = state.mu.at[:3].set(pose)
    sigma = state.sigma
    sigma = sigma.at[:3, :].set(A @ sigma[:3, :])
    sigma = sigma.at[:, :3].set(sigma[:, :3] @ A.T)
    sigma = sigma.at[:3, :3].add(Q)
    return state._replace(mu=mu, sigma=sigma, initialized=jnp.ones((), bool))


def predict_compose(pose0, initialized, controls: Control, config: SlamConfig):
    """Compose a block of encoder ticks into (pose, A, Q): the integrated
    pose mean and the folded 3x3 covariance transform
    ``sigma' = blockdiag(A, I) sigma blockdiag(A, I)^T + blockdiag(Q, 0)``
    — the cheap sequential part of :func:`predict_block`, exposed so the
    batched Triton frame kernel can apply the big-sigma touch itself."""
    odom = config.odom
    cov = config.covariance
    dtype = pose0.dtype
    eye3 = jnp.eye(3, dtype=dtype)

    def tick(carry, ctrl):
        pose, A, Q, initialized = carry
        wl, wr, dt = ctrl
        delta_sl = odom.kl * dt * wl
        delta_sr = odom.kr * dt * wr
        delta_theta = (delta_sr - delta_sl) / (2.0 * odom.b)
        delta_s = 0.5 * (delta_sr + delta_sl)
        tmp_th = pose[2] + 0.5 * delta_theta
        c, s = jnp.cos(tmp_th), jnp.sin(tmp_th)
        new_pose = jnp.stack(
            [
                pose[0] + delta_s * c,
                pose[1] + delta_s * s,
                geometry.wrap_angle(pose[2] + delta_theta),
            ]
        )
        H = eye3.at[0, 2].set(-delta_s * s).at[1, 2].set(delta_s * c)
        if config.compat.process_noise_uses_kl_for_both_wheels:
            wkh = (0.5 * odom.kl * dt) * jnp.stack(
                [
                    jnp.stack([c, c]),
                    jnp.stack([s, s]),
                    jnp.stack([1.0 / odom.b, -1.0 / odom.b]),
                ]
            )
        else:
            wkh = (0.5 * dt) * jnp.stack(
                [
                    jnp.stack([odom.kl * c, odom.kr * c]),
                    jnp.stack([odom.kl * s, odom.kr * s]),
                    jnp.stack([odom.kl / odom.b, -odom.kr / odom.b]),
                ]
            )
        sigma_u = jnp.diag(
            jnp.stack([cov.Q_k * jnp.abs(wl), cov.Q_k * jnp.abs(wr)])
        )
        Qk = (wkh @ sigma_u @ wkh.T).astype(dtype)
        A_new = (H @ A).astype(dtype)
        Q_new = (H @ Q @ H.T + Qk).astype(dtype)
        # pre-init latch: this tick contributes nothing
        pose = jnp.where(initialized, new_pose, pose)
        A = jnp.where(initialized, A_new, A)
        Q = jnp.where(initialized, Q_new, Q)
        return (pose, A, Q, jnp.ones((), bool)), None

    init = (pose0, eye3, jnp.zeros((3, 3), dtype), initialized)
    (pose, A, Q, _), _ = jax.lax.scan(
        tick, init, (controls.wl, controls.wr, controls.dt)
    )
    return pose, A, Q


# ---------------------------------------------------------------------------
# Update (reference addImage, src/aruco_slam.cpp:76-287)
# ---------------------------------------------------------------------------


def _slot_selector(slot, n_dim, dtype):
    """One-hot row selector E [3, N] for landmark ``slot``'s block.

    Replaces dynamic_slice/gather: E @ x reads the block, E.T @ y writes it.
    Under vmap these become batched matmuls instead of gathers."""
    idx = 3 + 3 * slot
    iota = jnp.arange(n_dim, dtype=jnp.int32)
    return (iota[None, :] == (idx + jnp.arange(3, dtype=jnp.int32))[:, None]).astype(dtype)


def _known_landmark_update(mu, sigma, mu0, slot, z, Rk, seen_prev, last_obs, cfg: SlamConfig):
    """Sequential EKF correction for an existing landmark
    (src/aruco_slam.cpp:108-207). Returns (mu', sigma', new_last_obs_entry,
    diverged_flag, applied_flag)."""
    dtype = mu.dtype
    E = _slot_selector(slot, mu.shape[0], dtype)

    # Stale linearization point (frame-start mean), :119-134
    x, y, th = mu0[0], mu0[1], mu0[2]
    m = E @ mu0
    sth, cth = jnp.sin(th), jnp.cos(th)
    gdx = m[0] - x
    gdy = m[1] - y
    gdth = geometry.wrap_angle(m[2] - th)
    z_hat = jnp.stack([gdx * cth + gdy * sth, -gdx * sth + gdy * cth, gdth])
    ze = z - z_hat
    ze = ze.at[2].set(geometry.wrap_angle(ze[2]))

    # Observation Jacobian Gxm (3x6), :140-143
    Gp = jnp.stack(
        [
            jnp.stack([-cth, -sth, -gdx * sth + gdy * cth]),
            jnp.stack([sth, -cth, -gdx * cth - gdy * sth]),
            jnp.stack([jnp.zeros_like(cth), jnp.zeros_like(cth), -jnp.ones_like(cth)]),
        ]
    ).astype(dtype)
    Gl = jnp.stack(
        [
            jnp.stack([cth, sth, jnp.zeros_like(cth)]),
            jnp.stack([-sth, cth, jnp.zeros_like(cth)]),
            jnp.stack([jnp.zeros_like(cth), jnp.zeros_like(cth), jnp.ones_like(cth)]),
        ]
    ).astype(dtype)

    # Gx = Gxm F has nonzero columns only at [0:3] and the landmark block,
    # so B = Gx sigma needs just the pose rows and E-selected rows.
    sig_pose = sigma[:3, :]  # [3, N]
    sig_lm = E @ sigma  # [3, N]
    B = Gp @ sig_pose + Gl @ sig_lm  # [3, N] = Gx sigma
    S = B[:, :3] @ Gp.T + (B @ E.T) @ Gl.T + Rk.astype(dtype)
    # K = sigma Gx^T S^-1 = B^T S^-1 (sigma symmetric, S symmetric);
    # closed-form 3x3 solve (batched LU lowers to a sequential loop)
    # instead of the reference's explicit .inverse() (:146).
    K = linalg.solve3x3(S, B).T  # [N, 3]

    # Divergence check — log-only in the reference (:156-175), optionally a
    # real gate (quirk (d)).
    k_norm = jnp.linalg.norm(K)
    diverged = jnp.logical_or(
        jnp.linalg.norm(ze) >= cfg.compat.divergence_ze_norm,
        k_norm >= cfg.compat.divergence_k_norm,
    )

    mu_new = mu + K @ ze
    sigma_new = sigma - K @ B  # (I - K Gx) sigma

    # Stationary gate (quirk (c), :192-198): when the marker was seen last
    # frame with a near-identical measurement, the "pose-only" update is an
    # empty-block no-op — effective behavior: skip, and leave the recorded
    # last observation *unset* (reference pushes an uninitialized vector;
    # we define it as zeros).
    gate = jnp.zeros((), bool)
    if cfg.compat.stationary_gate:
        gate = jnp.logical_and(
            seen_prev,
            jnp.linalg.norm(last_obs - z) < cfg.compat.stationary_gate_eps,
        )
    reject = jnp.zeros((), bool)
    if cfg.compat.reject_divergent:
        reject = diverged
    skip = jnp.logical_or(gate, reject)

    mu_out = jnp.where(skip, mu, mu_new)
    sigma_out = jnp.where(skip, sigma, sigma_new)
    new_last_obs = jnp.where(gate, jnp.zeros_like(z), z)
    return mu_out, sigma_out, new_last_obs, diverged, jnp.logical_not(skip)


def _new_landmark_insert(mu, sigma, mu0, slot, z, Rk):
    """Augment the state with a new landmark (src/aruco_slam.cpp:208-260).

    Uses the stale pose (mu0) for the landmark's world pose and Jacobians —
    including the reference's f32 downcast of sin/cos (``float sinth``,
    :210-211) which is our native precision anyway — and the *current*
    sigma for the cross-covariance (:230,244).

    All writes go through the one-hot selector (slot entries are exactly
    zero pre-augmentation, so adds == sets) — no scatters.
    """
    dtype = mu.dtype
    E = _slot_selector(slot, mu.shape[0], dtype)
    sth, cth = jnp.sin(mu0[2]), jnp.cos(mu0[2])
    map_x = mu0[0] + cth * z[0] - sth * z[1]
    map_y = mu0[1] + sth * z[0] + cth * z[1]
    map_th = geometry.wrap_angle(mu0[2] + z[2])
    mu_new = mu + E.T @ jnp.stack([map_x, map_y, map_th]).astype(dtype)

    dx = map_x - mu0[0]
    dy = map_y - mu0[1]
    zero, one = jnp.zeros_like(cth), jnp.ones_like(cth)
    Gsk = jnp.stack(
        [
            jnp.stack([-cth, -sth, -sth * dx + cth * dy]),
            jnp.stack([sth, -cth, -dx * cth - dy * sth]),
            jnp.stack([zero, zero, -one]),
        ]
    ).astype(dtype)
    Gmi = jnp.stack(
        [
            jnp.stack([cth, sth, zero]),
            jnp.stack([-sth, cth, zero]),
            jnp.stack([zero, zero, one]),
        ]
    ).astype(dtype)

    sigma_s = sigma[:3, :3]
    inner = Gsk @ sigma_s @ Gsk.T + Rk.astype(dtype)
    # The reference transposes `inner` (:241) — symmetric, so a no-op kept
    # for fidelity of intent.
    sigma_mm = Gmi @ inner.T @ Gmi.T
    sigma_mx = -(Gmi @ Gsk) @ sigma[:3, :]  # [3, N]

    # sigma_mx's columns at the new slot are zero (slot inactive), so the
    # row add and col add don't overlap; the [slot, slot] 3x3 comes only
    # from the sigma_mm term.
    sigma_new = sigma + E.T @ sigma_mx + sigma_mx.T @ E + E.T @ (sigma_mm @ E)
    return mu_new, sigma_new


def lookup_slots(slot_ids: Array, ids: Array) -> Array:
    """Map marker ids -> state slots (-1 if unknown) — the reference's
    ``checkLandmark`` / ``aruco_id_map`` (src/aruco_slam.cpp:423-435) as a
    vectorized comparison instead of a tree map."""
    hit = slot_ids[None, :] == ids[:, None]  # [M, max_lm]
    found = jnp.any(hit, axis=1)
    idx = jnp.argmax(hit, axis=1).astype(jnp.int32)
    return jnp.where(found, idx, -1)


def update(state: EkfState, frame: FrameObservations, config: SlamConfig) -> EkfState:
    """Process one image frame's observations sequentially.

    Ordering matches the reference's priority queue (smallest map index
    first, new markers (index -1) before all known ones — aruco_slam.h:85-88);
    ties between new markers break by arrival order (the reference's heap
    order for equal keys is unspecified).
    """
    max_lm = config.ekf.max_landmarks
    m_obs = frame.ids.shape[0]
    dtype = state.mu.dtype

    slots = lookup_slots(state.slot_ids, frame.ids)  # frame-start slots
    arrival = jnp.arange(m_obs, dtype=jnp.int32)
    big = jnp.asarray(2_000_000_000, jnp.int32)
    order_key = jnp.where(frame.valid, slots * m_obs + arrival, big)
    perm = jnp.argsort(order_key)

    sorted_obs = FrameObservations(
        ids=frame.ids[perm], z=frame.z[perm], R=frame.R[perm], valid=frame.valid[perm]
    )
    sorted_slots = slots[perm]

    mu0 = state.mu  # stale linearization point (src/aruco_slam.cpp:88)
    frozen_last_obs = state.last_obs
    frozen_seen = state.seen_prev

    lm_iota = jnp.arange(max_lm, dtype=jnp.int32)

    def step(carry, ob):
        mu, sigma, slot_ids, n_lm, new_last, new_seen, diverged, dropped = carry
        ob_id, z, Rk, valid, slot = ob
        z = z.astype(dtype)
        is_known = slot >= 0
        has_room = n_lm < max_lm

        def do_known(_):
            sel = lm_iota == slot  # one-hot over slots (no gathers/scatters)
            m, s, nlo, div, _applied = _known_landmark_update(
                mu, sigma, mu0, slot, z, Rk,
                jnp.any(sel & frozen_seen),
                sel.astype(dtype) @ frozen_last_obs,
                config,
            )
            return (
                m, s, slot_ids, n_lm,
                jnp.where(sel[:, None], nlo[None, :], new_last),
                new_seen | sel,
                diverged + div.astype(jnp.int32),
                dropped,
            )

        def do_new(_):
            m, s = _new_landmark_insert(mu, sigma, mu0, n_lm, z, Rk)
            sel = lm_iota == n_lm
            return (
                m, s,
                jnp.where(sel, ob_id, slot_ids),
                n_lm + 1,
                # Reference pushes the new marker with last_observation_
                # uninitialized (defined here as zeros) — see quirk (c).
                jnp.where(sel[:, None], 0.0, new_last),
                new_seen | sel,
                diverged,
                dropped,
            )

        def do_drop(_):
            return (
                mu, sigma, slot_ids, n_lm, new_last, new_seen, diverged,
                dropped + 1,
            )

        def process(_):
            return jax.lax.cond(
                is_known,
                do_known,
                lambda __: jax.lax.cond(has_room, do_new, do_drop, __),
                _,
            )

        def skip(_):
            return (mu, sigma, slot_ids, n_lm, new_last, new_seen, diverged, dropped)

        return jax.lax.cond(valid, process, skip, None), None

    init = (
        state.mu,
        state.sigma,
        state.slot_ids,
        state.n_landmarks,
        state.last_obs,
        jnp.zeros_like(state.seen_prev),
        state.diverged,
        state.dropped,
    )
    xs = (sorted_obs.ids, sorted_obs.z, sorted_obs.R, sorted_obs.valid, sorted_slots)
    (mu, sigma, slot_ids, n_lm, new_last, new_seen, diverged, dropped), _ = (
        jax.lax.scan(step, init, xs)
    )

    if config.ekf.symmetrize_sigma:
        sigma = 0.5 * (sigma + sigma.T)

    # Skip everything if no encoder tick arrived yet (addImage early-out,
    # src/aruco_slam.cpp:84-85).
    def keep_old():
        return state

    def use_new():
        return EkfState(
            mu=mu, sigma=sigma, slot_ids=slot_ids, n_landmarks=n_lm,
            last_obs=new_last, seen_prev=new_seen,
            initialized=state.initialized, diverged=diverged, dropped=dropped,
        )

    return jax.lax.cond(state.initialized, use_new, keep_old)


# ---------------------------------------------------------------------------
# Fused frame update — the whole frame's sequential corrections in the
# observed-slot subspace, one [N, N] covariance touch per frame.
# ---------------------------------------------------------------------------


def update_fused(state: EkfState, frame: FrameObservations, config: SlamConfig) -> EkfState:
    """Algebraically exact reformulation of :func:`update` (same reference
    semantics, src/aruco_slam.cpp:76-287) that runs the frame's M sequential
    per-marker corrections without ever touching the [N, N] covariance
    inside the sequential chain.

    Why this is possible: the reference linearizes *every* observation of a
    frame at the frame-start mean (``mu = mu_`` at src/aruco_slam.cpp:88),
    so all innovations, observation Jacobians, landmark-insert poses, and
    the stationary-gate decisions are computable upfront. Two structural
    facts then collapse the chain:

    1. *Inserts* (all first, by the reference's queue order) are
       congruences sigma' = F sigma F' + additive, with F touching only the
       pose + new-slot columns. With Q the [N, a] selector of the frame's
       observed-slot + pose columns (a = 3 + 3M) and Y = sigma0 Q, the
       running covariance stays in the family
       sigma = sigma0 + Y V Q' + Q V' Y' + Q W Q', closed under inserts, so
       the insert chain is [a, 3]-sized recursions on (V, W).
    2. *Known-landmark corrections* with a shared stale linearization are
       exactly a block-LDL factorization of the stacked innovation matrix
       S_big = C G' + R (C = G sigma_ins, [3M, N]): the sequentially-
       updated S_i of the reference are S_big's Schur-complement diagonals
       D_i; the posterior covariance is the order-independent batch form
       sigma_ins - Chat' D^-1 Chat with Chat = L^-1 C; and the stale
       innovations make the mean correction exactly Chat' D^-1 ze (standard
       sequential processing would apply a further L^-1 to ze — the
       reference's stale-mu quirk drops precisely that factor). The
       per-observation gain norm for the divergence check
       (src/aruco_slam.cpp:156-175) is ||D_i^-1 Chat_i||_F.

    The sequential chain is therefore M tiny [3M, 3] eliminations plus M
    tiny subspace insert steps; every N-sized matmul happens once per
    frame, outside the chain.

    Sequential-vs-fused equivalence is exact in real arithmetic and tested
    to f32 tolerance (tests/test_fused_update.py). Requires at most one
    observation per marker id per frame (duplicate ids would alias subspace
    columns); the front-end guarantees this. Motivation: the sequential
    scan makes 16 dependent [N, N] updates per frame; this form makes one,
    which pays at large maps.
    """
    max_lm = config.ekf.max_landmarks
    M = frame.ids.shape[0]
    dtype = state.mu.dtype
    N = state.mu.shape[0]
    a = 3 + 3 * M
    cfg = config.compat

    # --- identical ordering to `update` ---------------------------------
    slots = lookup_slots(state.slot_ids, frame.ids)
    arrival = jnp.arange(M, dtype=jnp.int32)
    big = jnp.asarray(2_000_000_000, jnp.int32)
    order_key = jnp.where(frame.valid, slots * M + arrival, big)
    perm = jnp.argsort(order_key)
    ids_s = frame.ids[perm]
    z_s = frame.z[perm].astype(dtype)
    R_s = frame.R[perm].astype(dtype)
    valid_s = frame.valid[perm]
    slots_s = slots[perm]

    mu0 = state.mu
    S0 = state.sigma
    n0 = state.n_landmarks

    # --- upfront bookkeeping (all from frame-start state) ---------------
    known = valid_s & (slots_s >= 0)
    new_mask = valid_s & (slots_s < 0)
    new_rank = jnp.cumsum(new_mask.astype(jnp.int32)) - new_mask.astype(jnp.int32)
    inserted = new_mask & (n0 + new_rank < max_lm)
    assigned = jnp.clip(n0 + new_rank, 0, max_lm - 1)
    eff_slot = jnp.where(slots_s >= 0, slots_s, assigned)
    n_dropped = jnp.sum(new_mask & ~inserted).astype(jnp.int32)

    # Observed-slot subspace selector Q [N, a]: pose block + one 3-block per
    # (sorted) observation. Blocks of invalid observations may alias real
    # columns — harmless, their (U, V, W) entries stay exactly zero.
    base = 3 + 3 * eff_slot
    col_idx = jnp.concatenate(
        [jnp.arange(3, dtype=jnp.int32), (base[:, None] + jnp.arange(3)[None, :]).reshape(-1)]
    )
    Q = (col_idx[None, :] == jnp.arange(N, dtype=jnp.int32)[:, None]).astype(dtype)
    Y = S0 @ Q  # [N, a]
    T = Q.T @ Y  # [a, a]
    muQ = mu0 @ Q  # [a]

    x, y, th = mu0[0], mu0[1], mu0[2]
    sth, cth = jnp.sin(th), jnp.cos(th)
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    # Rotation R(th)^T — both Gl of the known update (:140-143) and Gmi of
    # the insert (:227-245).
    Rt = jnp.stack(
        [
            jnp.stack([cth, sth, zero]),
            jnp.stack([-sth, cth, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )

    lm = muQ[3:].reshape(M, 3)  # per-obs landmark state at frame start
    gdx = lm[:, 0] - x
    gdy = lm[:, 1] - y
    gdth = geometry.wrap_angle(lm[:, 2] - th)
    z_hat = jnp.stack(
        [gdx * cth + gdy * sth, -gdx * sth + gdy * cth, gdth], axis=1
    )
    ze = z_s - z_hat
    ze = ze.at[:, 2].set(geometry.wrap_angle(ze[:, 2]))
    zeros_m = jnp.zeros((M,), dtype)
    Gp = jnp.stack(
        [
            jnp.stack([-cth + zeros_m, -sth + zeros_m, -gdx * sth + gdy * cth], axis=1),
            jnp.stack([sth + zeros_m, -cth + zeros_m, -gdx * cth - gdy * sth], axis=1),
            jnp.stack([zeros_m, zeros_m, -1.0 + zeros_m], axis=1),
        ],
        axis=1,
    )  # [M, 3, 3]

    # Insert pieces (reference :210-253), all from mu0.
    ins_dx = cth * z_s[:, 0] - sth * z_s[:, 1]
    ins_dy = sth * z_s[:, 0] + cth * z_s[:, 1]
    p_new = jnp.stack(
        [x + ins_dx, y + ins_dy, geometry.wrap_angle(th + z_s[:, 2])], axis=1
    )
    Gsk = jnp.stack(
        [
            jnp.stack([-cth + zeros_m, -sth + zeros_m, -sth * ins_dx + cth * ins_dy], axis=1),
            jnp.stack([sth + zeros_m, -cth + zeros_m, -ins_dx * cth - ins_dy * sth], axis=1),
            jnp.stack([zeros_m, zeros_m, -1.0 + zeros_m], axis=1),
        ],
        axis=1,
    )  # [M, 3, 3]
    M3 = -(Rt[None] @ Gsk)  # [M, 3, 3]
    # The reference's `inner.T` transpose (:241) is a symmetric no-op; the
    # additive measurement-noise block of the insert:
    w_add = Rt[None] @ R_s @ Rt.T[None]  # [M, 3, 3]

    # Stationary gate (quirk (c)) from the frozen previous-frame records.
    lm_iota = jnp.arange(max_lm, dtype=jnp.int32)
    sel = (lm_iota[None, :] == eff_slot[:, None]) & known[:, None]  # [M, max_lm]
    f_seen = jnp.any(sel & state.seen_prev[None, :], axis=1)
    f_last = sel.astype(dtype) @ state.last_obs
    gate = jnp.zeros((M,), bool)
    if cfg.stationary_gate:
        gate = known & f_seen & (
            jnp.linalg.norm(f_last - z_s, axis=1) < cfg.stationary_gate_eps
        )
    ze_div = jnp.linalg.norm(ze, axis=1) >= cfg.divergence_ze_norm

    eye_a = jnp.eye(a, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)

    # --- phase A: landmark inserts (congruence chain in the subspace) ----
    # Sorted order puts all new markers first (the reference priority
    # queue's inverted operator<), so inserts form a prefix. Each insert is
    # the congruence sigma' = F sigma F' + Q e_j w_add e_j' Q' with
    # F = I + Q m Q', m = e_j M3 e_pose'; with
    # sigma = S0 + Y V Q' + Q V' Y' + Q W Q' the chain closes on (V, W):
    # V' = V + P3 m', W' = W + m B3' + B3 m' + m (Q' sigma Q)_pose m' + w_add.
    V = jnp.zeros((a, a), dtype)
    W = jnp.zeros((a, a), dtype)
    acc_b = jnp.zeros((a,), dtype)
    for j in range(M):
        c0, c1 = 3 + 3 * j, 6 + 3 * j
        insf = inserted[j].astype(dtype)
        T3 = T[:, :3]
        P3 = eye_a[:, :3] + V[:, :3]  # [a, 3]
        B3 = V.T @ T3 + W[:, :3]  # [a, 3]
        C33 = (T @ P3 + B3)[:3, :]  # [3, 3] pose block of Q' sigma Q
        m3 = insf * M3[j]
        V = V.at[:, c0:c1].add(P3 @ m3.T)
        rowj = m3 @ B3.T  # [3, a]
        W = W.at[c0:c1, :].add(rowj)
        W = W.at[:, c0:c1].add(rowj.T)
        W = W.at[c0:c1, c0:c1].add(m3 @ C33 @ m3.T + insf * w_add[j])
        acc_b = acc_b.at[c0:c1].add(insf * p_new[j])

    # --- phase B: all known corrections as one block-LDL elimination ----
    # Sequential Kalman corrections with a shared (stale) linearization
    # point are algebraically a block-LDL factorization of the stacked
    # innovation matrix S_big = C G' + R (C = G sigma_ins): the running
    # S_i are its Schur-complement diagonals D_i, the posterior covariance
    # is the order-independent batch form sigma_ins - Chat' D^-1 Chat with
    # Chat = L^-1 C, and the reference's stale innovations make the mean
    # correction exactly Chat' D^-1 ze (the L^-1 on ze that standard
    # sequential processing implies is dropped — quirk of src/
    # aruco_slam.cpp:88). The per-obs gain norm for the divergence check is
    # ||D_i^-1 Chat_i||_F. The sequential chain is therefore M tiny [3M, 3]
    # eliminations; nothing N-sized runs sequentially.
    QS = (eye_a + V.T) @ Y.T + (T @ V + W) @ Q.T  # [a, N] = Q' sigma_ins
    kf = known.astype(dtype)
    QS_pose = QS[:3, :]  # [3, N]
    QS_blk = QS[3:, :].reshape(M, 3, N)
    C = kf[:, None, None] * (Gp @ QS_pose[None] + Rt[None] @ QS_blk)
    Cm = C.reshape(3 * M, N)
    k = 3 * M
    CQ = Cm @ Q  # [k, a]
    CQ_pose = CQ[:, :3]
    CQ_blk = CQ[:, 3:].reshape(k, M, 3)
    Sb = jnp.einsum("kp,jqp->kjq", CQ_pose, Gp) + jnp.einsum(
        "kjp,qp->kjq", CQ_blk, Rt
    )
    Sb = (Sb * kf[None, :, None]).reshape(k, k)
    Rblk = kf[:, None, None] * R_s + (1.0 - kf)[:, None, None] * eye3
    for j in range(M):
        Sb = Sb.at[3 * j : 3 * j + 3, 3 * j : 3 * j + 3].add(Rblk[j])

    use_pre = known & ~gate  # reject-divergent refines this in-loop
    rows = jnp.arange(k)
    Srem = Sb
    Lmat = jnp.eye(k, dtype=dtype)
    Linv = jnp.eye(k, dtype=dtype)
    Dinv_all = jnp.zeros((M, 3, 3), dtype)
    used_f = jnp.zeros((M,), dtype)
    div_flags = jnp.zeros((M,), bool)
    for i in range(M):
        r0, r1 = 3 * i, 3 * i + 3
        Dblk = Srem[r0:r1, r0:r1]
        Dinv = linalg.inv3x3(0.5 * (Dblk + Dblk.T))
        Dinv_all = Dinv_all.at[i].set(Dinv)
        if i > 0:
            lrow = Lmat[r0:r1, :r0]  # [3, 3i]
            Linv = Linv.at[r0:r1, :r0].set(-(lrow @ Linv[:r0, :r0]))
        if cfg.reject_divergent:
            # Gain norm needed *before* deciding to use this observation.
            chat_i = Linv[r0:r1, :r1] @ Cm[:r1, :]
            k2 = jnp.sum((Dinv @ chat_i) ** 2)
            div_i = ze_div[i] | (jnp.sqrt(jnp.maximum(k2, 0.0)) >= cfg.divergence_k_norm)
            div_flags = div_flags.at[i].set(div_i)
            use_i = use_pre[i] & ~div_i
        else:
            use_i = use_pre[i]
        uf = use_i.astype(dtype)
        used_f = used_f.at[i].set(uf)
        colf = Srem[:, r0:r1] * (rows >= r0)[:, None].astype(dtype)
        LD = uf * (colf @ Dinv)  # [k, 3]
        Lmat = Lmat.at[:, r0:r1].add(LD * (rows >= r1)[:, None].astype(dtype))
        Srem = Srem - LD @ colf.T

    Chat = Linv @ Cm  # [k, N] = L^-1 C
    chat_b = Chat.reshape(M, 3, N)
    if cfg.reject_divergent:
        div = div_flags
    else:
        k2 = jnp.sum((Dinv_all @ chat_b) ** 2, axis=(1, 2))
        div = ze_div | (jnp.sqrt(jnp.maximum(k2, 0.0)) >= cfg.divergence_k_norm)
    div_cnt = jnp.sum(known & div).astype(jnp.int32)

    Cu = (used_f[:, None, None] * chat_b).reshape(k, N)
    DC = (Dinv_all @ (used_f[:, None, None] * chat_b)).reshape(k, N)
    dz = (Dinv_all @ (used_f[:, None] * ze)[..., None])[..., 0].reshape(k)

    # --- one full-state application -------------------------------------
    YV = Y @ V
    QW = Q @ W
    sigma = S0 + YV @ Q.T + Q @ YV.T + QW @ Q.T - Cu.T @ DC
    mu = mu0 + Q @ acc_b + Cu.T @ dz

    if config.ekf.symmetrize_sigma:
        sigma = 0.5 * (sigma + sigma.T)

    # --- bookkeeping, identical to the scan path ------------------------
    processed = known | inserted
    proc_sel = (lm_iota[None, :] == eff_slot[:, None]) & processed[:, None]
    new_last_val = jnp.where((known & ~gate)[:, None], z_s, jnp.zeros_like(z_s))
    touched = jnp.any(proc_sel, axis=0)
    last_obs = jnp.where(
        touched[:, None], proc_sel.astype(dtype).T @ new_last_val, state.last_obs
    )
    seen = touched
    ins_sel = (lm_iota[None, :] == assigned[:, None]) & inserted[:, None]
    slot_ids = jnp.where(
        jnp.any(ins_sel, axis=0),
        (ins_sel.astype(jnp.int32).T @ ids_s[:, None])[:, 0],
        state.slot_ids,
    )
    n_lm = n0 + jnp.sum(inserted).astype(jnp.int32)

    def keep_old():
        return state

    def use_new():
        return EkfState(
            mu=mu, sigma=sigma, slot_ids=slot_ids, n_landmarks=n_lm,
            last_obs=last_obs, seen_prev=seen,
            initialized=state.initialized,
            diverged=state.diverged + div_cnt,
            dropped=state.dropped + n_dropped,
        )

    return jax.lax.cond(state.initialized, use_new, keep_old)


# ---------------------------------------------------------------------------
# Output accessors (reference toRosPose / toRosMappedMarkers,
# src/aruco_slam.cpp:378-410,265-281)
# ---------------------------------------------------------------------------


def get_pose(state: EkfState):
    """Robot pose (x, y, theta) and its 3x3 covariance."""
    return state.mu[:3], state.sigma[:3, :3]


def get_map(state: EkfState, config: SlamConfig):
    """Landmark states [max_lm, 3], ids [max_lm], active mask [max_lm]."""
    max_lm = config.ekf.max_landmarks
    lms = state.mu[3:].reshape(max_lm, 3)
    active = jnp.arange(max_lm) < state.n_landmarks
    return lms, state.slot_ids, active
