"""Distributed bundle adjustment (L6) — BASELINE.md config 5.

Sharding layout (the scaling-book recipe: pick a mesh, shard the data so
collectives ride the interconnect, let XLA insert them):

- **Landmarks are block-partitioned** across the mesh axis; every shard
  owns ``L/D`` landmark blocks.
- **Observations live with their landmark's owner** (partitioned host-side
  by ``partition_problem``), so the Schur elimination of each landmark —
  its 3x3 ``Hll`` inverse, ``bl``, back-substitution — is entirely local.
- **Keyframe poses are replicated** ([K, 3] is tiny even at 10k keyframes:
  120 KB), as are the odometry-chain factors.

Per CG iteration the only cross-device traffic is one ``psum`` of the
[K, 3] reduced product — exactly the "reduced camera system over
psum/all-gather" reduction the BASELINE.json north star prescribes. The
per-GN-step linearization products (Hpp diagonal, rhs, reduced-rhs
correction) ride ONE fused variadic psum, so a GN step with ``cg`` CG
iterations costs exactly ``cg + 2`` collectives (+1 for the adaptive /
history cost). Everything runs inside one ``shard_map`` so XLA can
overlap the local elimination with the collective.

Why one psum per CG iteration is the exact-communication floor here (and
why s-step CG does not apply): the reduced operator is S = D - G G^T with
D replicated (Hpp + odometry chain) and G column-sharded by landmark
owner, so S v = D v - sum_d G_d(G_d^T v) — applying S to a replicated
vector requires one all-reduce, and S^2 v needs the completed S v first.
Classical s-step/pipelined CG saves *dot-product* reductions (our dots
are on replicated [K, 3] vectors — already free) and batches *halo*
exchanges (our matvec's communication is a global sum, not a halo), so
neither reduces the matvec all-reduce count. Making the matvec local
would require replicating G (an [N, 3, 3]-sized all-gather per GN step)
and would un-shard the CG compute — strictly worse at scale.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from aruco_slam_tpu.models import ba
from aruco_slam_tpu.models.ba import BAProblem
from aruco_slam_tpu.ops import geometry
from aruco_slam_tpu.ops import linalg as small_linalg

Array = jax.Array

AXIS = "x"


def _kf_table(ids, K, pad):
    return ba._rows_table(ids, K, pad)


def _odo_is_chain(problem: BAProblem) -> bool:
    oi = np.asarray(problem.odo_i)
    oj = np.asarray(problem.odo_j)
    M = len(oi)
    K = np.asarray(problem.poses).shape[0]
    return bool(
        M == K - 1
        and np.array_equal(oi, np.arange(M))
        and np.array_equal(oj, np.arange(1, M + 1))
        and np.asarray(problem.odo_valid).all()
    )


class ShardedBAProblem(NamedTuple):
    """Host-partitioned problem. D shards; leading axis of sharded fields
    is the mesh axis. Ls = landmarks per shard, Ns = padded obs per shard.

    The table fields carry the shard-local solver fast path (same design
    as models.ba.GatherTables): kf_rows turns the keyframe-keyed segment
    sums into padded gather-sums, lm_sort_rows/lm_flags/lm_ends drive the
    sorted-segmented-scan landmark reduction, the same tables inside the
    shard_map as on one device."""

    poses: Array  # [K, 3] replicated
    landmarks: Array  # [D, Ls, 3]
    obs_kf: Array  # [D, Ns]
    obs_lm: Array  # [D, Ns] LOCAL landmark index within the shard
    obs_z: Array  # [D, Ns, 3]
    obs_w: Array  # [D, Ns, 3, 3]
    obs_valid: Array  # [D, Ns]
    odo_i: Array  # [M] replicated
    odo_j: Array
    odo_z: Array
    odo_w: Array
    odo_valid: Array
    prior_w: Array  # [3, 3]
    kf_rows: Array  # [D, K, Omax]
    lm_sort_rows: Array  # [D, Ns]
    lm_flags: Array  # [D, Ns]
    lm_ends: Array  # [D, Ls]


def partition_problem(problem: BAProblem, n_shards: int) -> tuple[ShardedBAProblem, np.ndarray]:
    """Partition landmarks across shards and route each observation to its
    landmark's owner. Returns (sharded, lm_perm) where lm_perm maps global
    landmark slot -> row in the concatenated [D*Ls] output.

    Assignment is LPT (longest-processing-time) on observation counts with
    a per-shard landmark capacity: per-shard work between collectives is
    proportional to owned observations, and round-1's contiguous blocks
    left a 1.22x max/mean imbalance on the 10k/5k problem
    (benchmarks/scaling.py ``work_balance``); LPT brings it to ~1.00."""
    L = problem.landmarks.shape[0]
    Ls = -(-L // n_shards)  # ceil: per-shard landmark capacity

    obs_kf = np.asarray(problem.obs_kf)
    obs_lm = np.asarray(problem.obs_lm)
    obs_valid = np.asarray(problem.obs_valid)
    counts_lm = np.bincount(obs_lm[obs_valid], minlength=L)
    lm_owner = np.empty(L, np.int64)
    lm_local = np.empty(L, np.int64)
    loads = np.zeros(n_shards, np.int64)
    filled = np.zeros(n_shards, np.int64)
    for l in np.argsort(-counts_lm, kind="stable"):
        open_shards = np.nonzero(filled < Ls)[0]
        d = open_shards[np.argmin(loads[open_shards])]
        lm_owner[l] = d
        lm_local[l] = filled[d]
        filled[d] += 1
        loads[d] += counts_lm[l]

    owner = lm_owner[obs_lm]
    counts = [int(np.sum((owner == d) & obs_valid)) for d in range(n_shards)]
    Ns = max(1, max(counts))

    def shard_field(arr, d, sel, fill=0):
        out = np.full((Ns, *arr.shape[1:]), fill, dtype=arr.dtype)
        out[: sel.sum()] = arr[sel]
        return out

    K = np.asarray(problem.poses).shape[0]
    sk, sl, sz, sw, sv, lms = [], [], [], [], [], []
    srows, sflags, sends, skfrows = [], [], [], []
    for d in range(n_shards):
        sel = (owner == d) & obs_valid
        kf_d = shard_field(obs_kf, d, sel)
        lm_d = shard_field(lm_local[obs_lm].astype(np.int32), d, sel)
        sk.append(kf_d)
        sl.append(lm_d)
        sz.append(shard_field(np.asarray(problem.obs_z), d, sel))
        sw.append(shard_field(np.asarray(problem.obs_w), d, sel))
        v = np.zeros(Ns, bool)
        v[: sel.sum()] = True
        sv.append(v)
        block = np.zeros((Ls, 3), np.asarray(problem.landmarks).dtype)
        mine = np.nonzero(lm_owner == d)[0]
        block[lm_local[mine]] = np.asarray(problem.landmarks)[mine]
        lms.append(block)
        # shard-local solver tables (see ShardedBAProblem docstring)
        nv = int(sel.sum())
        order = np.argsort(lm_d[:nv], kind="stable").astype(np.int32)
        sorted_ids = lm_d[order]
        flags = np.zeros(Ns, bool)
        if nv:
            flags[0] = True
            flags[1:nv] = sorted_ids[1:] != sorted_ids[:-1]
        rows = np.full(Ns, Ns, np.int32)
        rows[:nv] = order
        counts_d = np.bincount(sorted_ids, minlength=Ls) if nv else np.zeros(Ls, np.int64)
        ends = np.full(Ls, Ns, np.int32)
        cum = np.cumsum(counts_d)
        ends[counts_d > 0] = (cum[counts_d > 0] - 1).astype(np.int32)
        srows.append(rows)
        sflags.append(flags)
        sends.append(ends)
        skfrows.append(_kf_table(kf_d[:nv], K, Ns))
    o_max = max(t.shape[1] for t in skfrows)
    skfrows = [
        np.concatenate(
            [t, np.full((K, o_max - t.shape[1]), Ns, np.int32)], axis=1
        )
        for t in skfrows
    ]

    sharded = ShardedBAProblem(
        poses=jnp.asarray(problem.poses),
        landmarks=jnp.asarray(np.stack(lms)),
        obs_kf=jnp.asarray(np.stack(sk)),
        obs_lm=jnp.asarray(np.stack(sl)),
        obs_z=jnp.asarray(np.stack(sz)),
        obs_w=jnp.asarray(np.stack(sw)),
        obs_valid=jnp.asarray(np.stack(sv)),
        odo_i=jnp.asarray(problem.odo_i),
        odo_j=jnp.asarray(problem.odo_j),
        odo_z=jnp.asarray(problem.odo_z),
        odo_w=jnp.asarray(problem.odo_w),
        odo_valid=jnp.asarray(problem.odo_valid),
        prior_w=jnp.asarray(problem.prior_w),
        kf_rows=jnp.asarray(np.stack(skfrows)),
        lm_sort_rows=jnp.asarray(np.stack(srows)),
        lm_flags=jnp.asarray(np.stack(sflags)),
        lm_ends=jnp.asarray(np.stack(sends)),
    )
    lm_perm = lm_owner * Ls + lm_local  # global slot -> concat row
    return sharded, lm_perm


def _local_problem(s: ShardedBAProblem) -> BAProblem:
    """View of one shard as a BAProblem keyed by local landmark indices.

    Inside shard_map the sharded leading axis remains with local size 1 —
    squeeze it."""
    return BAProblem(
        poses=s.poses,
        landmarks=s.landmarks[0],
        obs_kf=s.obs_kf[0],
        obs_lm=s.obs_lm[0],
        obs_z=s.obs_z[0],
        obs_w=s.obs_w[0],
        obs_valid=s.obs_valid[0],
        odo_i=s.odo_i,
        odo_j=s.odo_j,
        odo_z=s.odo_z,
        odo_w=s.odo_w,
        odo_valid=s.odo_valid,
        prior_w=s.prior_w,
    )


def solve_dist(
    sharded: ShardedBAProblem,
    mesh: Mesh,
    iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    adaptive: bool = False,
    deflate_gauge: bool = False,
):
    """Distributed Schur-CG Gauss-Newton. Returns
    (poses [K,3], landmarks [D*Ls,3], cost_history [iters+1]).

    ``adaptive`` / ``deflate_gauge`` mirror :func:`models.ba.solve` exactly
    (LM accept/reject; gauge-rotation-mode deflation of the CG) so the
    sharded solve stays numerically equal to the single-device one. The
    deflation adds one extra matvec per GN step — i.e. one extra [K, 3]
    psum — and no other collectives."""
    if isinstance(sharded.odo_i, jax.core.Tracer):
        # under an outer jit the index pattern is unknowable — use the
        # generic segment-sum odometry path
        odo_chain = False
    else:
        M = np.asarray(sharded.odo_i).shape[0]
        odo_chain = bool(
            M == np.asarray(sharded.poses).shape[0] - 1
            and np.array_equal(np.asarray(sharded.odo_i), np.arange(M))
            and np.array_equal(np.asarray(sharded.odo_j), np.arange(1, M + 1))
            and np.asarray(sharded.odo_valid).all()
        )
    fn = _solve_dist_jit(
        mesh, iters, cg_iters, float(damping), adaptive, deflate_gauge,
        odo_chain,
    )
    poses, landmarks, history = fn(sharded)
    return poses, landmarks.reshape(-1, 3), history


@functools.lru_cache(maxsize=None)
def _solve_dist_jit(
    mesh: Mesh,
    iters: int,
    cg_iters: int,
    damping: float,
    adaptive: bool,
    deflate_gauge: bool,
    odo_chain: bool,
):
    """Build + cache the jitted shard_map program for one solver config.

    The closure must NOT be rebuilt per call: a fresh ``jax.jit(shard_map(
    local fn))`` is a new cache key, so every invocation would retrace AND
    recompile — at the 10k/5k shape that was ~3 s per call against ~0.2 s
    per GN step of actual execution, and it silently dominated every
    round-3 "warm" distributed timing (the measured per-GN marginal cost
    was identical across 1- and 2-process runs; the whole cross-process
    delta sat in this fixed recompile)."""

    def shard_fn(s: ShardedBAProblem):
        local = _local_problem(s)
        tables = ba.GatherTables(
            kf_rows=s.kf_rows[0],
            odo_i_rows=None,
            odo_j_rows=None,
            lm_sort_rows=s.lm_sort_rows[0],
            lm_flags=s.lm_flags[0],
            lm_ends=s.lm_ends[0],
        )
        K = local.poses.shape[0]
        Ls = local.landmarks.shape[0]
        prior_pose = local.poses[0]
        eye = jnp.eye(3, dtype=local.poses.dtype)
        lam_floor = jnp.asarray(damping, local.poses.dtype)

        def local_cost(poses, landmarks):
            (r_obs, _, _, w_obs), (r_odo, _, _, w_odo) = ba._residuals(
                local._replace(poses=poses, landmarks=landmarks), poses, landmarks
            )
            c_obs = jnp.sum(r_obs[:, None, :] @ w_obs @ r_obs[:, :, None])
            c_odo = jnp.sum(r_odo[:, None, :] @ w_odo @ r_odo[:, :, None])
            r0 = poses[0] - prior_pose
            r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
            c_pr = r0 @ local.prior_w @ r0
            # obs part is shard-local; odo+prior identical everywhere
            return 0.5 * (jax.lax.psum(c_obs, AXIS) + c_odo + c_pr)

        def gn_step(carry, _):
            poses, landmarks, lam, last_cost = carry
            prob = local._replace(poses=poses, landmarks=landmarks)
            Hpp_obs, Hll, Apl, bp_obs, bl = ba.obs_linear_blocks(
                prob, poses, landmarks, K, Ls, tables
            )
            Hll_inv = small_linalg.inv3x3(Hll + lam * eye)
            # reduced-rhs correction term (local: Hll_inv, bl, Apl are all
            # shard-resident)
            u = (Hll_inv @ bl[..., None])[..., 0]
            back = (Apl @ u[prob.obs_lm][..., None])[..., 0]
            back_seg = ba._seg_sum(back, prob.obs_kf, K, tables.kf_rows)
            # ONE fused all-reduce for the whole GN-step linearization:
            # Hpp_obs [K,3,3] + bp_obs [K,3] + the rhs correction [K,3] are
            # mutually independent local sums, so they ride a single
            # variadic psum (VERDICT r3 item 1a; the compiled HLO carries
            # one all-reduce here — asserted in tests/test_parallel.py).
            Hpp_obs, bp_obs, back_seg = jax.lax.psum(
                (Hpp_obs, bp_obs, back_seg), AXIS
            )
            Hpp_odo, Hij, bp_odo = ba.odo_linear_blocks(
                prob, poses, landmarks, K, tables, odo_chain
            )
            Hpp_diag = Hpp_obs + Hpp_odo + lam * eye
            Hpp_diag = Hpp_diag.at[0].add(local.prior_w)

            r0 = prior_pose - poses[0]
            r0 = r0.at[2].set(geometry.wrap_angle(r0[2]))
            bp = bp_obs + bp_odo + jnp.zeros_like(bp_obs).at[0].set(
                local.prior_w @ r0
            )
            bs = bp - back_seg

            Minv = small_linalg.inv3x3(Hpp_diag)

            def matvec(v):
                out = (Hpp_diag @ v[..., None])[..., 0]
                if odo_chain:
                    ci = (Hij @ v[1:][..., None])[..., 0]
                    cj = (jnp.swapaxes(Hij, -1, -2) @ v[:-1][..., None])[..., 0]
                    out = out + ba._chain_pad_i(ci) + ba._chain_pad_j(cj)
                else:
                    vi = v[prob.odo_j]
                    out = out + jax.ops.segment_sum(
                        (Hij @ vi[..., None])[..., 0], prob.odo_i, num_segments=K
                    )
                    vj = v[prob.odo_i]
                    out = out + jax.ops.segment_sum(
                        (jnp.swapaxes(Hij, -1, -2) @ vj[..., None])[..., 0],
                        prob.odo_j, num_segments=K,
                    )
                t = (jnp.swapaxes(Apl, -1, -2) @ v[prob.obs_kf][..., None])[..., 0]
                t_lm = ba._seg_sum_lm(t, prob.obs_lm, Ls, tables)
                u2 = (Hll_inv @ t_lm[..., None])[..., 0]
                back2 = (Apl @ u2[prob.obs_lm][..., None])[..., 0]
                out = out - jax.lax.psum(
                    ba._seg_sum(back2, prob.obs_kf, K, tables.kf_rows), AXIS
                )
                return out

            def precond(r):
                return (Minv @ r[..., None])[..., 0]

            if deflate_gauge:
                v = ba.gauge_rotation_mode(poses)
                Sv = matvec(v)
                vSv = jnp.sum(v * Sv)
                safe_vSv = jnp.where(jnp.abs(vSv) < 1e-30, 1e-30, vSv)
                x0 = v * (jnp.sum(v * bs) / safe_vSv)
                r0 = bs - Sv * (jnp.sum(v * bs) / safe_vSv)

                def project(z):
                    return z - v * (jnp.sum(Sv * z) / safe_vSv)
            else:
                x0 = jnp.zeros_like(bs)
                r0 = bs

                def project(z):
                    return z

            z0 = project(precond(r0))

            def cg_body(c, _):
                x, r, z, p, rz = c
                Sp = matvec(p)
                denom = jnp.sum(p * Sp)
                alpha = rz / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
                x = x + alpha * p
                r = r - alpha * Sp
                z = project(precond(r))
                rz_new = jnp.sum(r * z)
                beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
                p = z + beta * p
                return (x, r, z, p, rz_new), None

            (dp, *_), _ = jax.lax.scan(
                cg_body, (x0, r0, z0, z0, jnp.sum(r0 * z0)), None,
                length=cg_iters,
            )

            # local landmark back-substitution
            t = (jnp.swapaxes(Apl, -1, -2) @ dp[prob.obs_kf][..., None])[..., 0]
            t_lm = ba._seg_sum_lm(t, prob.obs_lm, Ls, tables)
            dl = (Hll_inv @ (bl - t_lm)[..., None])[..., 0]

            new_poses = poses + dp
            new_poses = new_poses.at[:, 2].set(
                geometry.wrap_angle(new_poses[:, 2])
            )
            new_landmarks = landmarks + dl
            new_landmarks = new_landmarks.at[:, 2].set(
                geometry.wrap_angle(new_landmarks[:, 2])
            )
            c = local_cost(new_poses, new_landmarks)
            if adaptive:
                accept = c <= last_cost
                poses = jnp.where(accept, new_poses, poses)
                landmarks = jnp.where(accept, new_landmarks, landmarks)
                lam = jnp.where(
                    accept,
                    jnp.maximum(lam * 0.5, lam_floor),
                    jnp.minimum(lam * 10.0, 1e4),
                )
                c = jnp.where(accept, c, last_cost)
            else:
                poses, landmarks = new_poses, new_landmarks
            return (poses, landmarks, lam, c), c

        c0 = local_cost(local.poses, local.landmarks)
        (poses, landmarks, _, _), costs = jax.lax.scan(
            gn_step, (local.poses, local.landmarks, lam_floor, c0), None,
            length=iters,
        )
        history = jnp.concatenate([c0[None], costs])
        return poses, landmarks, history

    return jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(
                ShardedBAProblem(
                    poses=P(), landmarks=P(AXIS), obs_kf=P(AXIS),
                    obs_lm=P(AXIS), obs_z=P(AXIS), obs_w=P(AXIS),
                    obs_valid=P(AXIS), odo_i=P(), odo_j=P(), odo_z=P(),
                    odo_w=P(), odo_valid=P(), prior_w=P(),
                    kf_rows=P(AXIS), lm_sort_rows=P(AXIS),
                    lm_flags=P(AXIS), lm_ends=P(AXIS),
                ),
            ),
            out_specs=(P(), P(AXIS), P()),
        )
    )
