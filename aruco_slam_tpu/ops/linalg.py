"""Small fixed-size linear algebra, unrolled (L0).

``jnp.linalg.solve``/``inv`` lower to LU with pivoting — a sequential loop
program, a poor fit for *batched tiny* systems (every EKF update solves
a 3x3, every PnP iteration a 6x6, every BA landmark block inverts a
3x3). These closed-form / unrolled versions are
pure arithmetic: they fuse, vectorize, and vmap with zero control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def inv3x3(A: Array) -> Array:
    """Closed-form 3x3 inverse via the adjugate. Batched over leading dims."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 0, 2]
    d = A[..., 1, 0]
    e = A[..., 1, 1]
    f = A[..., 1, 2]
    g = A[..., 2, 0]
    h = A[..., 2, 1]
    i = A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    row0 = jnp.stack([co_a, -(b * i - c * h), b * f - c * e], axis=-1)
    row1 = jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], axis=-1)
    row2 = jnp.stack([co_c, -(a * h - b * g), a * e - b * d], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def solve3x3(A: Array, B: Array) -> Array:
    """A^{-1} B for 3x3 A (B is [..., 3] or [..., 3, k])."""
    Ai = inv3x3(A)
    if B.ndim == A.ndim - 1:
        return (Ai @ B[..., None])[..., 0]
    return Ai @ B


def cholesky_unrolled(A: Array, n: int) -> Array:
    """Lower-triangular Cholesky of SPD A [..., n, n], fully unrolled at
    trace time (n static, small). ~n^3/6 fused multiply-adds, no loops."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    rows = []
    zero = jnp.zeros_like(A[..., 0, 0])
    for i in range(n):
        rows.append(
            jnp.stack([L[i][j] if j <= i else zero for j in range(n)], axis=-1)
        )
    return jnp.stack(rows, axis=-2)


def solve_spd(A: Array, b: Array, n: int) -> Array:
    """Solve SPD A x = b for small static n via unrolled Cholesky.
    ``b [..., n]``."""
    L = cholesky_unrolled(A, n)
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return jnp.stack(x, axis=-1)


def homography_unit_square(quad: Array) -> Array:
    """Closed-form homography mapping the unit square (0,0),(1,0),(1,1),(0,1)
    to ``quad [..., 4, 2]`` (same corner order). No linear solve — the
    classic projective-mapping formulas (Heckbert), two 2x2 Cramer steps."""
    x0, y0 = quad[..., 0, 0], quad[..., 0, 1]
    x1, y1 = quad[..., 1, 0], quad[..., 1, 1]
    x2, y2 = quad[..., 2, 0], quad[..., 2, 1]
    x3, y3 = quad[..., 3, 0], quad[..., 3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1 = x1 - x2
    dx2 = x3 - x2
    dy1 = y1 - y2
    dy2 = y3 - y2
    det = dx1 * dy2 - dx2 * dy1
    inv_det = 1.0 / det
    g = (sx * dy2 - sy * dx2) * inv_det
    h = (sy * dx1 - sx * dy1) * inv_det
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    c = x0
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    f = y0
    one = jnp.ones_like(a)
    return jnp.stack(
        [
            jnp.stack([a, b, c], axis=-1),
            jnp.stack([d, e, f], axis=-1),
            jnp.stack([g, h, one], axis=-1),
        ],
        axis=-2,
    )
