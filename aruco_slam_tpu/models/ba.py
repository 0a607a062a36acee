"""Factor-graph back-end (L5): pose-graph / bundle adjustment over SE(2)
keyframes and marker landmarks.

The reference has no back-end — its map is filter-only and dies with the
process (SURVEY.md sections 3.5, 5.4). This module provides the batch
smoother demanded by BASELINE.md configs 2/4/5: a sparse Gauss-Newton /
Levenberg-Marquardt solver over

- **marker factors**   z = h(pose_k, lm_l) + noise, with h the same
  robot-frame relative observation model as the EKF (z_hat closed form at
  reference src/aruco_slam.cpp:127-134; loop closure falls out of marker
  re-observation since ArUco ids are global — the same trivial data
  association the reference exploits via ``aruco_id_map``, :423-435);
- **odometry factors** z = pose_i ⊖ pose_j between keyframes;
- a **prior** on pose 0 fixing the gauge.

Design: the normal equations are never materialized as a big
sparse matrix. Landmarks are eliminated by the Schur complement — each
landmark's 3x3 Hll block inverts in closed form, embarrassingly parallel —
and the reduced camera system S dp = bs is solved matrix-free with
preconditioned CG: every S @ v product is a batch of 3x3 matmuls plus
``segment_sum`` scatter-adds over keyframe/landmark indices. All loops are
``lax.scan`` / ``lax.fori_loop`` with static trip counts; everything vmaps
and shard_maps (see parallel.dist_ba: shard observations by landmark owner,
psum the [K, 3]-sized reduced products — that is the only cross-device
traffic per CG iteration).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from aruco_slam_tpu.ops import geometry
from aruco_slam_tpu.ops import linalg as small_linalg

Array = jax.Array


class BAProblem(NamedTuple):
    """Fixed-shape factor graph. K keyframes, L landmarks, N marker
    observations, M odometry/relative-pose factors."""

    poses: Array  # [K, 3] initial keyframe poses
    landmarks: Array  # [L, 3] initial landmark states
    obs_kf: Array  # [N] int32 keyframe index
    obs_lm: Array  # [N] int32 landmark index
    obs_z: Array  # [N, 3] measured relative (x, y, theta)
    obs_w: Array  # [N, 3, 3] information matrices (R^{-1})
    obs_valid: Array  # [N] bool
    odo_i: Array  # [M] int32
    odo_j: Array  # [M] int32
    odo_z: Array  # [M, 3]
    odo_w: Array  # [M, 3, 3]
    odo_valid: Array  # [M] bool
    prior_w: Array  # [3, 3] information anchoring pose 0 at its init value


class BAStats(NamedTuple):
    initial_cost: Array
    final_cost: Array
    cost_history: Array  # [iters+1]


class GatherTables(NamedTuple):
    """Precomputed dense gather tables replacing every ``segment_sum`` in
    the solver's hot loops: a padded row-index table turns each scatter
    (segment_sum) into a gather + dense reduction, which is
    bandwidth-bound. Pad entries point
    one past the end of the source array (a zero row appended before the
    gather), so no masking is needed.

    Keyframe/odometry reductions use padded row tables (kf_rows [K, Omax],
    odo_*_rows [K, Q*]). The landmark reduction is harder: landmark
    popularity is heavily skewed (a well-placed marker is seen by hundreds
    of keyframes while the mean is ~16), so one full-width [L, deg_max]
    table is mostly padding, and a capped table + overflow-segment_sum
    pays the scatter. Two forms ship:

    - DEGREE-CLASS BUCKETED TABLES (default when present): landmarks are
      grouped by ceil-pow2 observation degree, so each class is one
      gather + one dense sum with < 2x padding; tiny classes are merged
      upward to bound the op count (~6 classes at 10k/5k). One final
      gather (lm_rank [L]) restores landmark order from the class-sorted
      concatenation. This replaces the segmented scan, which is
      op-count-bound (~17 Hillis-Steele passes) rather than
      bandwidth-bound (benchmarks/_lm_bucket_probe.py times both). Gather
      cost goes by ROW rather than by row width, so classes wider than
      ``chunk`` (64) are
      stored TWO-LEVEL: a [n_chunks, chunk] row table (each high-degree
      landmark split into chunk-width runs, padding bounded by
      chunk-1 per landmark instead of cap-1) plus a small [n_c, max_runs]
      combine table over the chunk partials. At 10k/5k this cuts the
      padded gather rows 126k -> ~92k. A two-level entry appears in
      ``lm_bucket_tabs`` as a (chunk_tab, combine_tab) pair.
    - SORTED SEGMENTED SCAN (fallback; used by parallel/dist_ba, whose
      per-shard tables must stack to uniform shapes across shards):
      gather observations into landmark-sorted order (lm_sort_rows [Nv]),
      one segmented associative +-scan (lm_flags [Nv] segment starts),
      gather the [L] segment ends (lm_ends; Nv for empty landmarks)."""

    kf_rows: Array
    odo_i_rows: Array
    odo_j_rows: Array
    lm_sort_rows: Array
    lm_flags: Array
    lm_ends: Array
    # degree-class bucketed landmark tables (empty tuple = use the scan)
    lm_bucket_tabs: tuple = ()  # tuple of [n_class, cap] int32 row tables
    lm_rank: Array | None = None  # [L] class-sorted position per landmark


def _rows_table(ids, num_segments: int, pad: int, rows=None):
    """Host-side: [S, Rmax] row-index table, padded with ``pad``.

    ``rows``: optional source row numbers for each id (default arange) —
    used to build tables over a masked subset."""
    import numpy as np

    ids = np.asarray(ids)
    if rows is None:
        rows = np.arange(len(ids))
    counts = np.bincount(ids, minlength=num_segments)
    rmax = max(1, int(counts.max()) if len(ids) else 1)
    out = np.full((num_segments, rmax), pad, np.int32)
    order = np.argsort(ids, kind="stable")
    pos_ids = ids[order]
    # positions within each segment: cumulative index along sorted order
    seg_start = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=seg_start[1:])
    within = np.arange(len(ids)) - seg_start[pos_ids]
    out[pos_ids, within] = np.asarray(rows)[order]
    return out


def build_tables(problem: BAProblem) -> GatherTables:
    """Build the solver's gather tables (host-side numpy; call once per
    problem and pass to :func:`solve`)."""
    import numpy as np

    K = np.asarray(problem.poses).shape[0]
    L = np.asarray(problem.landmarks).shape[0]
    N = np.asarray(problem.obs_kf).shape[0]
    M = np.asarray(problem.odo_i).shape[0]

    valid = np.asarray(problem.obs_valid)
    rows_v = np.nonzero(valid)[0]
    obs_lm = np.asarray(problem.obs_lm)[valid]
    order = np.argsort(obs_lm, kind="stable")
    lm_sort_rows = rows_v[order].astype(np.int32)
    sorted_ids = obs_lm[order]
    nv = len(sorted_ids)
    flags = np.ones(nv, bool)
    if nv > 1:
        flags[1:] = sorted_ids[1:] != sorted_ids[:-1]
    counts = np.bincount(sorted_ids, minlength=L)
    ends = np.full(L, nv, np.int32)  # empty landmarks gather the zero row
    cum = np.cumsum(counts)
    nonempty = counts > 0
    ends[nonempty] = (cum[nonempty] - 1).astype(np.int32)

    # degree-class bucketed tables (see GatherTables docstring)
    deg = counts
    cls = np.zeros(L, np.int64)
    cls[deg > 1] = np.ceil(np.log2(deg[deg > 1])).astype(np.int64)
    # merge classes with < 2048 padded rows upward: one fewer gather+sum
    # pair each, at most 2048 extra padded rows per merge
    uniq = np.unique(cls)
    for i in range(len(uniq) - 1):
        c = uniq[i]
        if int((cls == c).sum()) << int(c) < 2048:
            cls[cls == c] = uniq[i + 1]
    lm_order = np.argsort(cls, kind="stable")
    rank = np.empty(L, np.int64)
    rank[lm_order] = np.arange(L)
    cls_sorted = cls[lm_order]
    within = np.arange(nv) - (cum[sorted_ids] - counts[sorted_ids])
    chunk = 64  # two-level split width for wide classes (see docstring)
    bucket_tabs = []
    for c in np.unique(cls):
        sel = cls_sorted == c
        n_c = int(sel.sum())
        start = int(np.searchsorted(cls_sorted, c))
        cap = 1 << int(c)
        m = cls[sorted_ids] == c
        lm_in_c = rank[sorted_ids[m]] - start  # class-local landmark index
        if cap <= chunk:
            # pad entries gather the zero row appended at index N
            tab = np.full((n_c, cap), N, np.int64)
            tab[lm_in_c, within[m]] = lm_sort_rows[m]
            bucket_tabs.append(jnp.asarray(tab.astype(np.int32)))
            continue
        # two-level: per-landmark chunk runs + combine table
        deg_c = np.bincount(lm_in_c, minlength=n_c)
        runs = np.maximum(1, -(-deg_c // chunk))  # ceil(deg / chunk)
        run_off = np.zeros(n_c + 1, np.int64)
        np.cumsum(runs, out=run_off[1:])
        total_runs = int(run_off[-1])
        chunk_tab = np.full((total_runs, chunk), N, np.int64)
        w = within[m]
        chunk_tab[run_off[lm_in_c] + w // chunk, w % chunk] = lm_sort_rows[m]
        max_runs = int(runs.max())
        # pad entries gather the zero partial row appended at total_runs
        comb_tab = np.full((n_c, max_runs), total_runs, np.int64)
        for i in range(max_runs):
            has = runs > i
            comb_tab[has, i] = run_off[:-1][has] + i
        bucket_tabs.append(
            (
                jnp.asarray(chunk_tab.astype(np.int32)),
                jnp.asarray(comb_tab.astype(np.int32)),
            )
        )

    return GatherTables(
        kf_rows=jnp.asarray(_rows_table(problem.obs_kf, K, N)),
        odo_i_rows=jnp.asarray(_rows_table(problem.odo_i, K, M)),
        odo_j_rows=jnp.asarray(_rows_table(problem.odo_j, K, M)),
        lm_sort_rows=jnp.asarray(lm_sort_rows),
        lm_flags=jnp.asarray(flags),
        lm_ends=jnp.asarray(ends),
        lm_bucket_tabs=tuple(bucket_tabs),
        lm_rank=jnp.asarray(rank.astype(np.int32)),
    )


def prepare(problem: BAProblem):
    """Pack the problem for the solver fast path. Returns
    (packed_problem, tables, static) where ``static`` is a dict of
    Python-level solver options to splat into :func:`solve`:

    - observations are permuted into keyframe-major dense layout
      ([K, kf_width] slots, zero-weight pads), so every keyframe-keyed
      reduction becomes a reshape + dense sum and the ``v[obs_kf]`` gather
      becomes a broadcast (static ``kf_width``);
    - the odometry chain (odo_i == 0..K-2, odo_j == 1..K-1 — what the
      graph builders emit) is detected and handled with shifted pad-adds
      instead of segment sums (static ``odo_chain``);
    - landmark-keyed reductions use the sorted-segmented-scan tables of
      :func:`build_tables`.

    Everything stays numerically identical to the unpacked solve up to f32
    summation order. Motivation: the segment_sum formulation is
    scatter/gather-bound at the 10k/5k shape (benchmarks/ba_prims_probe.py
    measures the primitives)."""
    import numpy as np

    K = np.asarray(problem.poses).shape[0]
    N = np.asarray(problem.obs_kf).shape[0]
    valid = np.asarray(problem.obs_valid)
    vrows = np.nonzero(valid)[0]
    kf_v = np.asarray(problem.obs_kf)[vrows]
    counts = np.bincount(kf_v, minlength=K)
    O = max(1, int(counts.max()))
    perm = np.full((K, O), N, np.int64)
    order = np.argsort(kf_v, kind="stable")
    rows_sorted = vrows[order]
    kf_sorted = kf_v[order]
    seg_start = np.zeros(K + 1, np.int64)
    np.cumsum(counts, out=seg_start[1:])
    within = np.arange(len(kf_sorted)) - seg_start[kf_sorted]
    perm[kf_sorted, within] = rows_sorted
    perm = perm.reshape(-1)

    def g(arr):
        a = np.asarray(arr)
        padded = np.concatenate([a, np.zeros((1, *a.shape[1:]), a.dtype)])
        return padded[perm]

    packed = problem._replace(
        obs_kf=np.repeat(np.arange(K, dtype=np.int32), O),
        obs_lm=g(problem.obs_lm).astype(np.int32),
        obs_z=g(problem.obs_z),
        obs_w=g(problem.obs_w),
        obs_valid=(perm != N),
    )
    oi = np.asarray(problem.odo_i)
    oj = np.asarray(problem.odo_j)
    M = len(oi)
    odo_chain = bool(
        M == K - 1
        and np.array_equal(oi, np.arange(M))
        and np.array_equal(oj, np.arange(1, M + 1))
        and np.asarray(problem.odo_valid).all()
    )
    tables = build_tables(packed)
    packed = jax.tree.map(jnp.asarray, packed)
    return packed, tables, {"kf_width": O, "odo_chain": odo_chain}


def _sum_rows(vals: Array, rows: Array) -> Array:
    """Gather-sum: equivalent of segment_sum(vals, ids) given the row
    table for ids. vals [N, ...] -> [S, ...]."""
    padded = jnp.concatenate(
        [vals, jnp.zeros((1, *vals.shape[1:]), vals.dtype)], axis=0
    )
    return jnp.sum(padded[rows], axis=1)


def _seg_sum(vals: Array, ids: Array, num_segments: int, rows):
    """segment_sum, or the gather-sum form when a row table is given."""
    if rows is None:
        return jax.ops.segment_sum(vals, ids, num_segments=num_segments)
    return _sum_rows(vals, rows)


def _seg_sum_lm(vals: Array, ids: Array, L: int, tables):
    """Landmark-keyed reduction (see GatherTables): degree-class bucketed
    gather-sums when the tables carry them (a few dense ops in place of
    the scan's ~17 passes, benchmarks/_lm_bucket_probe.py), else the
    sorted segmented scan."""
    if tables is None:
        return jax.ops.segment_sum(vals, ids, num_segments=L)
    # flatten trailing dims of rank-3+ operands: a [N, 3, 3] operand would
    # otherwise carry its (3, 3) minor dims through the scan in tile-padded
    # layout ([N, 3] operands measured faster unflattened)
    flat = vals if vals.ndim == 2 else vals.reshape(vals.shape[0], -1)
    padded = jnp.concatenate(
        [flat, jnp.zeros((1, flat.shape[1]), flat.dtype)], axis=0
    )
    if tables.lm_bucket_tabs:
        parts = []
        for t in tables.lm_bucket_tabs:
            if isinstance(t, tuple):  # two-level wide class
                chunk_tab, comb_tab = t
                partial = padded[chunk_tab].sum(axis=1)  # [n_runs, F]
                pp = jnp.concatenate(
                    [partial, jnp.zeros((1, flat.shape[1]), flat.dtype)],
                    axis=0,
                )
                parts.append(pp[comb_tab].sum(axis=1))
            else:
                parts.append(padded[t].sum(axis=1))
        out = jnp.concatenate(parts, axis=0)[tables.lm_rank]
        return out.reshape(L, *vals.shape[1:])
    s = padded[tables.lm_sort_rows]  # [Nv, F] lm-sorted
    f = tables.lm_flags

    def comb(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb[:, None], vb, va + vb), fa | fb

    scanned, _ = jax.lax.associative_scan(comb, (s, f), axis=0)
    out_padded = jnp.concatenate(
        [scanned, jnp.zeros((1, flat.shape[1]), flat.dtype)], axis=0
    )
    return out_padded[tables.lm_ends].reshape(L, *vals.shape[1:])


def _obs_jacobians(pose: Array, target: Array):
    """h(pose, target) = target in pose frame; returns (h, Jp, Jt).

    Jp/Jt are the analytic 3x6 observation Jacobian halves of the EKF
    (reference Gxm, src/aruco_slam.cpp:140-143), batched."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    s, c = jnp.sin(th), jnp.cos(th)
    dx = target[..., 0] - x
    dy = target[..., 1] - y
    h = jnp.stack(
        [
            dx * c + dy * s,
            -dx * s + dy * c,
            geometry.wrap_angle(target[..., 2] - th),
        ],
        axis=-1,
    )
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    Jp = jnp.stack(
        [
            jnp.stack([-c, -s, -dx * s + dy * c], axis=-1),
            jnp.stack([s, -c, -dx * c - dy * s], axis=-1),
            jnp.stack([zero, zero, -one], axis=-1),
        ],
        axis=-2,
    )
    Jt = jnp.stack(
        [
            jnp.stack([c, s, zero], axis=-1),
            jnp.stack([-s, c, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return h, Jp, Jt


def _residuals(problem: BAProblem, poses, landmarks):
    """All whitened residual blocks + Jacobians at the current estimate."""
    # marker factors
    p_obs = poses[problem.obs_kf]
    l_obs = landmarks[problem.obs_lm]
    h, Jp, Jl = _obs_jacobians(p_obs, l_obs)
    r_obs = problem.obs_z - h
    r_obs = r_obs.at[..., 2].set(geometry.wrap_angle(r_obs[..., 2]))
    w_obs = jnp.where(
        problem.obs_valid[:, None, None], problem.obs_w, 0.0
    )
    # odometry factors
    pi = poses[problem.odo_i]
    pj = poses[problem.odo_j]
    ho, Ji, Jj = _obs_jacobians(pi, pj)
    r_odo = problem.odo_z - ho
    r_odo = r_odo.at[..., 2].set(geometry.wrap_angle(r_odo[..., 2]))
    w_odo = jnp.where(
        problem.odo_valid[:, None, None], problem.odo_w, 0.0
    )
    return (r_obs, Jp, Jl, w_obs), (r_odo, Ji, Jj, w_odo)


def cost(problem: BAProblem, poses, landmarks, prior_pose) -> Array:
    (r_obs, _, _, w_obs), (r_odo, _, _, w_odo) = _residuals(
        problem, poses, landmarks
    )
    c_obs = jnp.sum(r_obs[:, None, :] @ w_obs @ r_obs[:, :, None])
    c_odo = jnp.sum(r_odo[:, None, :] @ w_odo @ r_odo[:, :, None])
    r0 = poses[0] - prior_pose
    r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
    c_pr = r0 @ problem.prior_w @ r0
    return 0.5 * (c_obs + c_odo + c_pr)


def _kf_sum(vals: Array, ids, K: int, rows, kf_width):
    """Keyframe-keyed reduction: dense reshape-sum (kf-major packed
    layout), gather table, or segment_sum."""
    if kf_width is not None:
        return jnp.sum(vals.reshape(K, kf_width, *vals.shape[1:]), axis=1)
    return _seg_sum(vals, ids, K, rows)


def _obs_blocks(obs_parts, problem: BAProblem, K: int, L: int, tables,
                kf_width):
    """obs_linear_blocks body, from already-evaluated residual parts (so
    _linearize can evaluate :func:`_residuals` exactly once per GN step
    instead of relying on XLA CSE across repeated calls)."""
    r_obs, Jp, Jl, w_obs = obs_parts
    JpW = jnp.swapaxes(Jp, -1, -2) @ w_obs  # [N, 3, 3] = Jp^T W
    JlW = jnp.swapaxes(Jl, -1, -2) @ w_obs
    App = JpW @ Jp
    All = JlW @ Jl
    Apl = JpW @ Jl
    bp_obs = (JpW @ r_obs[..., None])[..., 0]
    bl_obs = (JlW @ r_obs[..., None])[..., 0]
    kf_rows = tables.kf_rows if tables is not None else None
    Hpp_diag = _kf_sum(App, problem.obs_kf, K, kf_rows, kf_width)
    Hll = _seg_sum_lm(All, problem.obs_lm, L, tables)
    bp = _kf_sum(bp_obs, problem.obs_kf, K, kf_rows, kf_width)
    bl = _seg_sum_lm(bl_obs, problem.obs_lm, L, tables)
    return Hpp_diag, Hll, Apl, bp, bl


def obs_linear_blocks(
    problem: BAProblem, poses, landmarks, K: int, L: int, tables=None,
    kf_width=None,
):
    """Marker-factor linear blocks (the shardable part of the problem).

    Sign convention: residual r = z - h, Jacobians J of h, so the normal
    equations are (J^T W J) d = + J^T W r.

    Returns (Hpp_diag_obs [K,3,3], Hll [L,3,3], Apl [N,3,3], bp_obs [K,3],
    bl [L,3]) — everything keyed by *local* landmark indices, so a shard of
    observations + its owned landmark block compute these independently;
    only Hpp_diag_obs and bp_obs need a psum across shards."""
    obs_parts, _ = _residuals(problem, poses, landmarks)
    return _obs_blocks(obs_parts, problem, K, L, tables, kf_width)


def _chain_pad_i(x: Array) -> Array:
    """Place per-factor values at their i endpoint (0..K-2) of a K-row
    output: pad one zero row at the end."""
    return jnp.concatenate([x, jnp.zeros((1, *x.shape[1:]), x.dtype)], axis=0)


def _chain_pad_j(x: Array) -> Array:
    """Place per-factor values at their j endpoint (1..K-1)."""
    return jnp.concatenate([jnp.zeros((1, *x.shape[1:]), x.dtype), x], axis=0)


def _odo_blocks(odo_parts, problem: BAProblem, K: int, tables, odo_chain):
    """odo_linear_blocks body from already-evaluated residual parts."""
    oi = tables.odo_i_rows if tables is not None else None
    oj = tables.odo_j_rows if tables is not None else None
    r_odo, Ji, Jj, w_odo = odo_parts
    JiW = jnp.swapaxes(Ji, -1, -2) @ w_odo
    JjW = jnp.swapaxes(Jj, -1, -2) @ w_odo
    Hij = JiW @ Jj  # [M, 3, 3] off-diagonal block (i, j)
    bi = (JiW @ r_odo[..., None])[..., 0]
    bj = (JjW @ r_odo[..., None])[..., 0]
    if odo_chain:
        Hpp_diag = _chain_pad_i(JiW @ Ji) + _chain_pad_j(JjW @ Jj)
        bp = _chain_pad_i(bi) + _chain_pad_j(bj)
    else:
        Hpp_diag = _seg_sum(JiW @ Ji, problem.odo_i, K, oi)
        Hpp_diag = Hpp_diag + _seg_sum(JjW @ Jj, problem.odo_j, K, oj)
        bp = _seg_sum(bi, problem.odo_i, K, oi)
        bp = bp + _seg_sum(bj, problem.odo_j, K, oj)
    return Hpp_diag, Hij, bp


def odo_linear_blocks(
    problem: BAProblem, poses, landmarks, K: int, tables=None, odo_chain=False
):
    """Odometry/relative-pose linear blocks (replicated, cheap)."""
    _, odo_parts = _residuals(problem, poses, landmarks)
    return _odo_blocks(odo_parts, problem, K, tables, odo_chain)


def _linearize(
    problem: BAProblem, poses, landmarks, damping, tables=None,
    kf_width=None, odo_chain=False, prior_pose=None,
):
    """Build the blocks needed by the Schur-CG solve (single device)."""
    K = poses.shape[0]
    L = landmarks.shape[0]
    obs_parts, odo_parts = _residuals(problem, poses, landmarks)
    Hpp_obs, Hll, Apl, bp_obs, bl = _obs_blocks(
        obs_parts, problem, K, L, tables, kf_width
    )
    Hpp_odo, Hij, bp_odo = _odo_blocks(
        odo_parts, problem, K, tables, odo_chain
    )
    Hpp_diag = Hpp_obs + Hpp_odo
    bp = bp_obs + bp_odo

    # Prior on pose 0 (gauge)
    Hpp_diag = Hpp_diag.at[0].add(problem.prior_w)

    # LM damping on both diagonals
    eye = jnp.eye(3, dtype=poses.dtype)
    Hpp_diag = Hpp_diag + damping * eye
    Hll = Hll + damping * eye
    Hll_inv = small_linalg.inv3x3(Hll)  # [L, 3, 3] closed-form batched

    # Entering-state cost, fused into the linearization pass: the residual
    # blocks are already materialized here, so this is two tiny quadratic
    # reductions instead of the full standalone residual recompute that
    # ``cost`` pays (saves one [N]-scale pass per GN iteration in the
    # non-adaptive solve, which reuses this as "cost after previous step").
    r_obs, _, _, w_obs = obs_parts
    r_odo, _, _, w_odo = odo_parts
    c_obs = jnp.sum(r_obs[:, None, :] @ w_obs @ r_obs[:, :, None])
    c_odo = jnp.sum(r_odo[:, None, :] @ w_odo @ r_odo[:, :, None])
    if prior_pose is not None:
        r0c = poses[0] - prior_pose
        r0c = r0c.at[2].set(geometry.wrap_angle(r0c[2]))
        c_pr = r0c @ problem.prior_w @ r0c
    else:
        c_pr = jnp.zeros((), poses.dtype)
    cost_in = 0.5 * (c_obs + c_odo + c_pr)

    return dict(
        Hpp_diag=Hpp_diag, Hll_inv=Hll_inv, Apl=Apl, Hij=Hij,
        bp=bp, bl=bl, cost_in=cost_in,
    )


def _schur_matvec(lin, problem: BAProblem, v, tables=None, kf_width=None,
                  odo_chain=False):
    """S @ v with S = Hpp - Hpl Hll^-1 Hlp, matrix-free.

    v: [K, 3]. With the :func:`prepare` fast path every keyframe-keyed
    reduction is a dense reshape-sum, the chain odometry coupling is two
    shifted pad-adds, and only the landmark side touches index tables —
    no scatter anywhere in the CG loop."""
    K = v.shape[0]
    L = lin["Hll_inv"].shape[0]
    kf_rows = tables.kf_rows if tables is not None else None
    # Hpp @ v: diagonal part
    out = (lin["Hpp_diag"] @ v[..., None])[..., 0]
    # odometry coupling: out_i += Hij v_j ; out_j += Hij^T v_i
    if odo_chain:
        ci = (lin["Hij"] @ v[1:][..., None])[..., 0]
        cj = (jnp.swapaxes(lin["Hij"], -1, -2) @ v[:-1][..., None])[..., 0]
        out = out + _chain_pad_i(ci) + _chain_pad_j(cj)
    else:
        oi = tables.odo_i_rows if tables is not None else None
        oj = tables.odo_j_rows if tables is not None else None
        vi = v[problem.odo_j]
        contrib_i = (lin["Hij"] @ vi[..., None])[..., 0]
        out = out + _seg_sum(contrib_i, problem.odo_i, K, oi)
        vj = v[problem.odo_i]
        contrib_j = (jnp.swapaxes(lin["Hij"], -1, -2) @ vj[..., None])[..., 0]
        out = out + _seg_sum(contrib_j, problem.odo_j, K, oj)
    # - Hpl Hll^-1 Hlp v
    if kf_width is not None:
        v_obs = jnp.broadcast_to(
            v[:, None, :], (K, kf_width, 3)
        ).reshape(-1, 3)
    else:
        v_obs = v[problem.obs_kf]
    t = (jnp.swapaxes(lin["Apl"], -1, -2) @ v_obs[..., None])[..., 0]
    t_lm = _seg_sum_lm(t, problem.obs_lm, L, tables)  # [L, 3]
    u = (lin["Hll_inv"] @ t_lm[..., None])[..., 0]  # [L, 3]
    back = (lin["Apl"] @ u[problem.obs_lm][..., None])[..., 0]  # [N, 3]
    out = out - _kf_sum(back, problem.obs_kf, K, kf_rows, kf_width)
    return out


def gauge_rotation_mode(poses: Array) -> Array:
    """The near-flat eigen-direction of the reduced camera system: a global
    rotation of all keyframes about the anchored pose 0.

    Global map orientation is pinned only through the odometry chain back to
    the pose-0 prior, so this mode's curvature is orders of magnitude below
    the rest of the spectrum and block-Jacobi CG crawls along it
    (tests/test_ba.py::test_gauge_deflation_recovers_flat_mode). Per
    keyframe k the
    infinitesimal generator is d(x_k, y_k, th_k)/d(phi) =
    (-(y_k - y_0), x_k - x_0, 1). Normalized."""
    d = poses[:, :2] - poses[0, :2]
    v = jnp.stack([-d[:, 1], d[:, 0], jnp.ones_like(d[:, 0])], axis=-1)
    return v / jnp.linalg.norm(v)


def _pcg(
    lin,
    problem: BAProblem,
    rhs,
    iters: int,
    deflate: Array | None = None,
    tables=None,
    kf_width=None,
    odo_chain=False,
):
    """Preconditioned CG on the reduced system; block-Jacobi preconditioner
    from the Hpp diagonal blocks.

    ``deflate`` (optional [K, 3]) is a deflation vector: its 1-D component
    of the solution is computed directly up front (alpha = v.b / v.Sv — a
    well-conditioned ratio even when both are tiny) and the Krylov space is
    kept S-orthogonal to it, so a near-flat mode no longer throttles
    convergence. Cost: one extra matvec up front, one dot + axpy per
    iteration."""
    Minv = small_linalg.inv3x3(lin["Hpp_diag"])

    def precond(r):
        return (Minv @ r[..., None])[..., 0]

    if deflate is not None:
        v = deflate
        Sv = _schur_matvec(lin, problem, v, tables, kf_width, odo_chain)
        vSv = jnp.sum(v * Sv)
        safe_vSv = jnp.where(jnp.abs(vSv) < 1e-30, 1e-30, vSv)
        x0 = v * (jnp.sum(v * rhs) / safe_vSv)
        r0 = rhs - Sv * (jnp.sum(v * rhs) / safe_vSv)

        def project(z):
            return z - v * (jnp.sum(Sv * z) / safe_vSv)
    else:
        x0 = jnp.zeros_like(rhs)
        r0 = rhs

        def project(z):
            return z

    z0 = project(precond(r0))
    p0 = z0

    def body(carry, _):
        x, r, z, p, rz = carry
        Sp = _schur_matvec(lin, problem, p, tables, kf_width, odo_chain)
        denom = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
        x = x + alpha * p
        r = r - alpha * Sp
        z = project(precond(r))
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
        p = z + beta * p
        return (x, r, z, p, rz_new), jnp.sum(r * r)

    rz0 = jnp.sum(r0 * z0)
    (x, r, _, _, _), res_hist = jax.lax.scan(
        body, (x0, r0, z0, p0, rz0), None, length=iters
    )
    return x, res_hist


def solve(
    problem: BAProblem,
    iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    adaptive: bool = False,
    deflate_gauge: bool = False,
    tables: GatherTables | None = None,
    kf_width: int | None = None,
    odo_chain: bool = False,
    unroll: bool = False,
):
    """Run Gauss-Newton / Levenberg-Marquardt with Schur-complement CG.
    Returns (poses, landmarks, BAStats).

    ``unroll``: emit the GN loop as straight-line code instead of
    ``lax.scan``. Same math and history; the scan boundary can add layout
    round-trips of the carried state per GN iteration
    (benchmarks/_gn_structure_probe.py measures it), so the throughput
    benchmarks unroll. Compile time scales with ``iters``; keep the scan (default)
    for large ``iters`` or when compile latency matters. Applies to the
    NON-adaptive path only: ``adaptive=True`` always uses ``lax.scan``
    (its accept/reject carry gains nothing from unrolling) and silently
    ignores ``unroll``.

    ``tables`` (:func:`build_tables`): precomputed gather tables that
    replace every segment_sum/scatter in the solver with padded gather-sums
    (see :class:`GatherTables`). Results are identical up to f32
    summation order.

    ``adaptive``: LM accept/reject — re-evaluate the cost after each step;
    on increase, reject the step and raise the damping 10x (capped), on
    decrease accept and relax it 2x toward the ``damping`` floor. One extra
    cost evaluation per iteration; with ``adaptive=False`` the behavior is
    the round-1 fixed-damping GN, bit-identical.

    ``deflate_gauge``: deflate the near-flat global-rotation gauge mode out
    of CG and solve its 1-D component directly (see
    :func:`gauge_rotation_mode`) — closes the block-Jacobi crawl along that
    mode that previously demanded 60x400 iterations for convergence on
    loop-closure problems."""
    prior_pose = problem.poses[0]
    lam_floor = jnp.asarray(damping, problem.poses.dtype)

    def gn_step(carry, _):
        poses, landmarks, lam, last_cost = carry
        lin = _linearize(
            problem, poses, landmarks, lam, tables, kf_width, odo_chain,
            prior_pose,
        )
        # prior residual into bp[0]
        r0 = prior_pose - poses[0]
        r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
        bp = lin["bp"].at[0].add(problem.prior_w @ r0)
        # reduced rhs: bs = bp - Hpl Hll^-1 bl
        L = landmarks.shape[0]
        kf_rows = tables.kf_rows if tables is not None else None
        u = (lin["Hll_inv"] @ lin["bl"][..., None])[..., 0]
        back = (lin["Apl"] @ u[problem.obs_lm][..., None])[..., 0]
        bs = bp - _kf_sum(back, problem.obs_kf, poses.shape[0], kf_rows, kf_width)
        deflate = gauge_rotation_mode(poses) if deflate_gauge else None
        dp, _ = _pcg(
            lin, problem, bs, cg_iters, deflate=deflate, tables=tables,
            kf_width=kf_width, odo_chain=odo_chain,
        )
        # back-substitute landmarks: dl = Hll^-1 (bl - Hlp dp)
        if kf_width is not None:
            dp_obs = jnp.broadcast_to(
                dp[:, None, :], (poses.shape[0], kf_width, 3)
            ).reshape(-1, 3)
        else:
            dp_obs = dp[problem.obs_kf]
        t = (jnp.swapaxes(lin["Apl"], -1, -2) @ dp_obs[..., None])[..., 0]
        t_lm = _seg_sum_lm(t, problem.obs_lm, L, tables)
        dl = (lin["Hll_inv"] @ (lin["bl"] - t_lm)[..., None])[..., 0]
        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(geometry.wrap_angle(new_poses[:, 2]))
        new_landmarks = landmarks + dl
        new_landmarks = new_landmarks.at[:, 2].set(
            geometry.wrap_angle(new_landmarks[:, 2])
        )
        if adaptive:
            c = cost(problem, new_poses, new_landmarks, prior_pose)
            accept = c <= last_cost
            poses = jnp.where(accept, new_poses, poses)
            landmarks = jnp.where(accept, new_landmarks, landmarks)
            lam = jnp.where(
                accept,
                jnp.maximum(lam * 0.5, lam_floor),
                jnp.minimum(lam * 10.0, 1e4),
            )
            c = jnp.where(accept, c, last_cost)
            return (poses, landmarks, lam, c), c
        # Non-adaptive: the entering-state cost computed inside the
        # linearization pass IS "cost after the previous step" — emitting
        # it (plus one standalone evaluation after the loop) yields the
        # same history without the per-iteration residual recompute.
        return (new_poses, new_landmarks, lam, lin["cost_in"]), lin["cost_in"]

    init = problem.poses, problem.landmarks, lam_floor
    if adaptive:
        c0 = cost(problem, problem.poses, problem.landmarks, prior_pose)
        (poses, landmarks, _, _), costs = jax.lax.scan(
            gn_step, (*init, c0), None, length=iters
        )
        history = jnp.concatenate([c0[None], costs])
    else:
        carry = (*init, jnp.zeros((), problem.poses.dtype))
        if unroll:
            emitted = []
            for _ in range(iters):
                carry, c = gn_step(carry, None)
                emitted.append(c)
            costs = (
                jnp.stack(emitted)
                if emitted
                else jnp.zeros((0,), problem.poses.dtype)
            )
        else:
            carry, costs = jax.lax.scan(gn_step, carry, None, length=iters)
        poses, landmarks = carry[0], carry[1]
        c_final = cost(problem, poses, landmarks, prior_pose)
        history = jnp.concatenate([costs, c_final[None]])
    return poses, landmarks, BAStats(
        initial_cost=history[0], final_cost=history[-1], cost_history=history
    )
