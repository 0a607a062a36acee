"""Pallas kernel (Triton route): the whole PnP front-end (normalize ->
Heckbert homography -> Zhang init -> dual-start Gauss-Newton ->
observation + covariance + gates) for every (sequence, marker-slot) pair
of a frame in one launch, one pair per thread.

Why: under ``vmap`` XLA turns the per-marker 3x3 and 4-corner algebra of
``ops.pnp.solve_pnp_square`` into many small fusions and tiny batched
dots per frame. Each marker's PnP is independent straight-line math, so
here a program takes a power-of-two block of pairs and every quantity is
one value per pair.

Math is a term-by-term transcription of ``ops.pnp.solve_pnp_square`` +
``ops.frontend.observations_from_corners``, including the full
Brown-Conrady camera (reference parseCameraInfo passes D straight
through, src/aruco_slam_node.cpp:121-130): corners are undistorted
in-kernel with the same 8-step fixed point as
``camera.undistort_normalized``, and the covariance's reprojection error
applies the forward distortion. Loads and stores are masked for the tail
block and invalid slots; invalid slots come out with ``keep = 0``. All
arithmetic is elementwise float32 (no ``pl.dot``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from aruco_slam_tpu.utils.config import SlamConfig

Array = jax.Array

# params vector layout (input [NP])
_P_FX, _P_FY, _P_CX, _P_CY, _P_HALF, _P_THRESH = 0, 1, 2, 3, 4, 5
_P_RX, _P_RY, _P_RTH, _P_T2CX, _P_T2CY = 6, 7, 8, 9, 10
_P_K1, _P_K2, _P_P1, _P_P2, _P_K3 = 11, 12, 13, 14, 15
NP = 16

# fixed-point trip count of camera.undistort_normalized's default — the
# XLA path (pnp.pixels_to_normalized) uses the same, so results match.
_UNDISTORT_ITERS = 8

# (sequence, slot) pairs per program: one pair per thread at 4 warps.
BLOCK = 128


def _wrap(a):
    two_pi = 2.0 * jnp.pi
    a = jnp.where(a >= jnp.pi, a - two_pi, a)
    return jnp.where(a < -jnp.pi, a + two_pi, a)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _norm3(a):
    return jnp.sqrt(_dot3(a, a))


def _matmul3(X, Y):
    return [
        [sum(X[i][k] * Y[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]


def _rodrigues(w0, w1, w2):
    """Axis-angle -> 3x3 rotation, matching geometry.rodrigues (series
    form under theta < 1e-8)."""
    theta = jnp.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
    small = theta < 1e-8
    safe = jnp.where(small, 1.0, theta)
    kx, ky, kz = w0 / safe, w1 / safe, w2 / safe
    st = jnp.sin(theta)
    ct1 = 1.0 - jnp.cos(theta)
    one = jnp.ones_like(theta)
    zero = jnp.zeros_like(theta)
    K = [[zero, -kz, ky], [kz, zero, -kx], [-ky, kx, zero]]
    KK = _matmul3(K, K)
    R = [
        [
            (one if i == j else zero) + st * K[i][j] + ct1 * KK[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    # tiny angle: I + skew(raw rvec)
    Rs = [[one, -w2, w1], [w2, one, -w0], [-w1, w0, one]]
    return [
        [jnp.where(small, Rs[i][j], R[i][j]) for j in range(3)]
        for i in range(3)
    ]


def _solve_spd6(A, b):
    """Unrolled Cholesky solve (transcribes linalg.solve_spd)."""
    n = 6
    Lm = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - Lm[i][k] * Lm[j][k]
            if i == j:
                Lm[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                Lm[i][j] = s / Lm[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - Lm[i][k] * y[k]
        y[i] = s / Lm[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - Lm[k][i] * x[k]
        x[i] = s / Lm[i][i]
    return x


def _residual(R, t, xn, yn, obj):
    r, pcs = [], []
    for k in range(4):
        X, Y = obj[k]
        px = R[0][0] * X + R[0][1] * Y + t[0]
        py = R[1][0] * X + R[1][1] * Y + t[1]
        pz = R[2][0] * X + R[2][1] * Y + t[2]
        inv_z = 1.0 / pz
        r += [px * inv_z - xn[k], py * inv_z - yn[k]]
        pcs.append([px, py, pz])
    return r, pcs


def _gn_refine(R, t, xn, yn, obj, iters):
    """Gauss-Newton on normalized reprojection residuals, the per-pair form
    of pnp._gauss_newton_refine (carried residual + cheap trust region).
    R: 3x3 values, t: [3], xn/yn: [4], obj: 4 (X, Y) scalars."""

    def step(_, carry):
        R, t, r, pc = carry
        J = []
        for k in range(4):
            X, Y = obj[k]
            px, py, pz = pc[k]
            inv_z = 1.0 / pz
            iz2 = inv_z * inv_z
            zero = jnp.zeros_like(inv_z)
            # M = R @ skew(X_k) with X_k = (X, Y, 0):
            # skew = [[0, 0, Y], [0, 0, -X], [-Y, X, 0]]
            M = [
                [-Y * R[i][2], X * R[i][2], Y * R[i][0] - X * R[i][1]]
                for i in range(3)
            ]
            # dpdc rows: [inv_z, 0, -px iz2], [0, inv_z, -py iz2]; the
            # rotation block is dpdc @ (-M), the translation block dpdc
            J.append(
                [-(inv_z * M[0][c] - px * iz2 * M[2][c]) for c in range(3)]
                + [inv_z, zero, -px * iz2]
            )
            J.append(
                [-(inv_z * M[1][c] - py * iz2 * M[2][c]) for c in range(3)]
                + [zero, inv_z, -py * iz2]
            )
        JtJ = [
            [
                sum(J[m][a] * J[m][b] for m in range(8))
                + (1e-9 if a == b else 0.0)
                for b in range(6)
            ]
            for a in range(6)
        ]
        Jtr = [sum(J[m][a] * r[m] for m in range(8)) for a in range(6)]
        d = _solve_spd6(JtJ, Jtr)
        dR = _rodrigues(-d[0], -d[1], -d[2])
        R_new = _matmul3(R, dR)
        t_new = [t[0] - d[3], t[1] - d[4], t[2] - d[5]]
        r_new, pc_new = _residual(R_new, t_new, xn, yn, obj)
        better = sum(q * q for q in r_new) < sum(q * q for q in r)
        pick = lambda a, b: jnp.where(better, a, b)
        return jax.tree.map(pick, (R_new, t_new, r_new, pc_new), (R, t, r, pc))

    r, pc = _residual(R, t, xn, yn, obj)
    R, t, r, pc = jax.lax.fori_loop(0, iters, step, (R, t, r, pc))
    return R, t, pc, sum(q * q for q in r)


def _pnp_kernel(
    corners_ref, valid_ref, params_ref, z_out, rdiag_out, keep_out,
    *, settle: int, finish: int,
):
    n_pairs = valid_ref.shape[0]
    lanes = pl.program_id(0) * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    in_range = lanes < n_pairs
    valid = plgpu.load(valid_ref.at[lanes], mask=in_range, other=0) != 0
    live = in_range & valid

    p = lambda k: params_ref[k]
    fx, fy = p(_P_FX), p(_P_FY)
    cx, cy = p(_P_CX), p(_P_CY)
    half = p(_P_HALF)
    k1, k2, k3 = p(_P_K1), p(_P_K2), p(_P_K3)
    p1, p2 = p(_P_P1), p(_P_P2)

    def corner(c):
        return plgpu.load(corners_ref.at[c, lanes], mask=live, other=0.0)

    u = [corner(2 * k) for k in range(4)]
    v = [corner(2 * k + 1) for k in range(4)]

    # Brown-Conrady undistortion, unrolled fixed point (transcription of
    # camera.undistort_normalized). With zero coefficients every iteration
    # is the exact identity, so zero-distortion results are unchanged.
    xn, yn = [], []
    for k in range(4):
        xd = (u[k] - cx) / fx
        yd = (v[k] - cy) / fy
        x, y = xd, yd
        for _ in range(_UNDISTORT_ITERS):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = p1 * 2.0 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p2 * 2.0 * x * y + p1 * (r2 + 2.0 * y * y)
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        xn.append(x)
        yn.append(y)

    # object points TL, TR, BR, BL on the z=0 plane (pnp.marker_object_points)
    obj = [(-half, half), (half, half), (half, -half), (-half, -half)]

    # --- Heckbert homography unit square -> corners_norm -----------------
    x0, x1, x2, x3 = xn
    y0, y1, y2, y3 = yn
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dx2 = x1 - x2, x3 - x2
    dy1, dy2 = y1 - y2, y3 - y2
    inv_det = 1.0 / (dx1 * dy2 - dx2 * dy1)
    g = (sx * dy2 - sy * dx2) * inv_det
    h_ = (sy * dx1 - sx * dy1) * inv_det
    a = x1 - x0 + g * x1
    b = x3 - x0 + h_ * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h_ * y3
    one = jnp.ones_like(a)
    Hu = [[a, b, x0], [d, e, y0], [g, h_, one]]

    # H = Hu @ A_inv, A_inv = [[1/L, 0, h/L], [0, -1/L, h/L], [0, 0, 1]]
    # (unit square -> object square; pnp._homography_init)
    Lm = 2.0 * half
    h1 = [Hu[i][0] * (1.0 / Lm) for i in range(3)]
    h2 = [Hu[i][1] * (-1.0 / Lm) for i in range(3)]
    h3 = [
        Hu[i][0] * (half / Lm) + Hu[i][1] * (half / Lm) + Hu[i][2]
        for i in range(3)
    ]
    lam = 2.0 / (_norm3(h1) + _norm3(h2))
    t = [q * lam for q in h3]
    flip = jnp.where(t[2] < 0, -1.0, 1.0)
    r1 = [q * lam * flip for q in h1]
    r2 = [q * lam * flip for q in h2]
    t = [q * flip for q in t]
    # symmetrized Gram-Schmidt (Zhang), then r3 = r1 x r2
    r1n = [q / _norm3(r1) for q in r1]
    d21 = _dot3(r2, r1n)
    r2o = [r2[i] - d21 * 0.5 * r1n[i] for i in range(3)]
    d12 = _dot3(r1n, r2o)
    n22 = _dot3(r2o, r2o)
    r1o = [r1n[i] - d12 * 0.5 * r2o[i] / n22 for i in range(3)]
    r1o = [q / _norm3(r1o) for q in r1o]
    d2o = _dot3(r2o, r1o)
    r2o = [r2o[i] - d2o * r1o[i] for i in range(3)]
    r2o = [q / _norm3(r2o) for q in r2o]
    r3 = _cross3(r1o, r2o)
    R0 = [[r1o[i], r2o[i], r3[i]] for i in range(3)]  # columns r1o r2o r3

    # --- planar two-fold ambiguity: flipped start (pnp._planar_flip) ------
    tn = _norm3(t)
    vv = [q / tn for q in t]
    nrm = [R0[i][2] for i in range(3)]
    axr = _cross3(vv, nrm)
    s_ = _norm3(axr)
    ax = [q / jnp.maximum(s_, 1e-9) for q in axr]
    # rotation by -2*theta about ax, where sin(theta) = s_ and
    # cos(theta) = v.n (both unit vectors): sin(-2t) = -2 s c and
    # 1 - cos(-2t) = 2 s^2 feed Rodrigues directly.
    cs = _dot3(vv, nrm)
    st = -2.0 * s_ * cs
    omc = 2.0 * s_ * s_
    zero_ = jnp.zeros_like(s_)
    one_ = jnp.ones_like(s_)
    K = [[zero_, -ax[2], ax[1]], [ax[2], zero_, -ax[0]],
         [-ax[1], ax[0], zero_]]
    KK = _matmul3(K, K)
    Rf = [
        [
            (one_ if i == j else zero_) + st * K[i][j] + omc * KK[i][j]
            for j in range(3)
        ]
        for i in range(3)
    ]
    Rb0 = _matmul3(Rf, R0)

    # --- dual-start settle, winner finish ---------------------------------
    Ra, ta, _, res_a = _gn_refine(R0, t, xn, yn, obj, settle)
    Rb, tb, _, res_b = _gn_refine(Rb0, t, xn, yn, obj, settle)
    pick_b = res_b < res_a
    R1 = [[jnp.where(pick_b, Rb[i][j], Ra[i][j]) for j in range(3)]
          for i in range(3)]
    t1 = [jnp.where(pick_b, tb[i], ta[i]) for i in range(3)]
    R, t, pc, _ = _gn_refine(R1, t1, xn, yn, obj, finish)

    # --- observation + covariance + gates (ops.frontend) ------------------
    # rms: MEAN-SQUARED pixel reprojection error (reference semantics,
    # src/aruco_slam.cpp:460-465): the final pose's corner camera points
    # through the full distorted pinhole (camera.project_points) against
    # the raw detected pixels.
    rms = jnp.zeros_like(u[0])
    for k in range(4):
        pcx, pcy, pcz = pc[k]
        inv_z = 1.0 / pcz
        x_p = pcx * inv_z
        y_p = pcy * inv_z
        r2 = x_p * x_p + y_p * y_p
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy2 = 2.0 * x_p * y_p
        x_dst = x_p * radial + p1 * xy2 + p2 * (r2 + 2.0 * x_p * x_p)
        y_dst = y_p * radial + p2 * xy2 + p1 * (r2 + 2.0 * y_p * y_p)
        du = fx * x_dst + cx - u[k]
        dv = fy * y_dst + cy - v[k]
        rms = rms + du * du + dv * dv
    rms = rms * 0.25
    diag_px = jnp.sqrt((u[0] - u[2]) ** 2 + (v[0] - v[2]) ** 2)
    tnorm = _norm3(t)
    obj_err = (rms / diag_px) * (tnorm / Lm)
    rdiag = [
        obj_err * p(_P_RX) + 1e-2,
        obj_err * p(_P_RY) + 1e-2,
        obj_err * p(_P_RTH) + 1e-3,
    ]
    z = [
        t[2] + p(_P_T2CX),
        -t[0] + p(_P_T2CY),
        _wrap(jnp.arctan2(-R[0][2], R[2][2])),
    ]
    cov_norm = jnp.sqrt(sum(q * q for q in rdiag))
    keep = live & (tnorm <= p(_P_THRESH)) & (cov_norm <= 1.0)

    for c in range(3):
        plgpu.store(z_out.at[c, lanes], z[c], mask=in_range)
        plgpu.store(rdiag_out.at[c, lanes], rdiag[c], mask=in_range)
    plgpu.store(keep_out.at[lanes], jnp.where(keep, 1, 0), mask=in_range)


@functools.partial(jax.jit, static_argnames=("config", "interpret"))
def pnp_frontend_batch(
    ids: Array,  # [B, M] int32
    corners: Array,  # [B, M, 4, 2] pixel corners
    valid: Array,  # [B, M] bool
    camera,  # CameraIntrinsics (full 5-term Brown-Conrady supported)
    config: SlamConfig,
    interpret: bool = False,
):
    """Batched PnP front-end, one kernel launch for all B * M pairs: the
    batched ``frontend.observations_from_corners``. Returns
    ``ekf.FrameObservations`` with ``[B, M, ...]`` fields."""
    from aruco_slam_tpu.models.ekf import FrameObservations

    batch, m, _, _ = corners.shape
    n_pairs = batch * m
    dtype = jnp.float32
    flat = corners.astype(dtype).reshape(n_pairs, 8).T  # [8, P]
    params = jnp.stack(
        [
            jnp.asarray(camera.fx, dtype), jnp.asarray(camera.fy, dtype),
            jnp.asarray(camera.cx, dtype), jnp.asarray(camera.cy, dtype),
            jnp.asarray(config.aruco.marker_length / 2.0, dtype),
            jnp.asarray(config.useful_distance_threshold, dtype),
            jnp.asarray(config.covariance.R_x, dtype),
            jnp.asarray(config.covariance.R_y, dtype),
            jnp.asarray(config.covariance.R_theta, dtype),
            jnp.asarray(config.t_r2c_x, dtype),
            jnp.asarray(config.t_r2c_y, dtype),
            *(jnp.asarray(camera.dist[i], dtype) for i in range(5)),
        ]
    )
    iters = config.aruco.pnp_refine_iters
    settle = min(2, iters)
    finish = max(iters - settle, 1)
    z_t, rdiag_t, keep = pl.pallas_call(
        functools.partial(_pnp_kernel, settle=settle, finish=finish),
        out_shape=(
            jax.ShapeDtypeStruct((3, n_pairs), dtype),
            jax.ShapeDtypeStruct((3, n_pairs), dtype),
            jax.ShapeDtypeStruct((n_pairs,), jnp.int32),
        ),
        grid=(pl.cdiv(n_pairs, BLOCK),),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="pnp_frontend",
    )(flat, valid.reshape(n_pairs).astype(jnp.int32), params)
    z = z_t.T.reshape(batch, m, 3)
    rdiag = rdiag_t.T.reshape(batch, m, 3)
    R = rdiag[..., :, None] * jnp.eye(3, dtype=dtype)
    return FrameObservations(
        ids=ids, z=z, R=R, valid=(keep != 0).reshape(batch, m)
    )
