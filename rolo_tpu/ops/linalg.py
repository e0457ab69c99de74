"""Small batched linear algebra helpers for solver hot paths.

The reference does per-correspondence Eigen 4x4 inverses and 3x3/6x6 LDLT
solves (rot_vgicp_impl.hpp:215-219, lsq_registration_impl.hpp:102,288).
Here the equivalents are closed-form batched kernels that XLA fuses into the
surrounding elementwise work — no LAPACK calls inside the LM loop.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv3x3(m: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Closed-form adjugate inverse of [..., 3, 3] matrices.

    Replaces the reference's per-correspondence Eigen .inverse() on the
    (block-diagonal) 4x4 combined covariance (rot_vgicp_impl.hpp:215-219);
    the 4th row/col there is identically zero so the 3x3 block inverse is
    exact.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, jnp.where(det < 0, -1e-30, 1e-30), det)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    out = adj * inv_det[..., None, None]
    if eps:
        out = out + eps * jnp.eye(3, dtype=m.dtype)
    return out


def cholesky_solve_unrolled(h: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """Pivot-free Cholesky solve of [..., n, n] x = [..., n], fully
    unrolled to scalar ops at trace time. Stable for the PSD systems the
    solvers produce (Eigen LDLT territory) and — unlike jnp.linalg.solve —
    fuses into the surrounding program instead of lowering to XLA's
    batched tiny-matrix LU kernel (the scan2map plane fit solves
    [12288, 3, 3] systems per bind)."""
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                l[i][j] = s / l[j][j]
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y.append(s / l[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, axis=-1)


def cholesky_solve_unrolled_mat(h: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """`cholesky_solve_unrolled` with a MATRIX right-hand side: solves
    h X = B for [..., n, n] h and [..., n, m] B, unrolled over n at trace
    time with the trailing RHS axis m kept vectorized. Same stability
    domain (PSD systems) and fusion behavior as the vector variant."""
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                l[i][j] = s / l[j][j]
    y = []
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[i][k][..., None] * y[k]
        y.append(s / l[i][i][..., None])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i][..., None] * x[k]
        x[i] = s / l[i][i][..., None]
    return jnp.stack(x, axis=-2)


def inv_psd_unrolled(h: jnp.ndarray, n: int) -> jnp.ndarray:
    """Explicit inverse of [..., n, n] PSD matrices via the unrolled
    Cholesky solve against an identity RHS (no XLA tiny-matrix LU)."""
    eye = jnp.broadcast_to(jnp.eye(n, dtype=h.dtype), h.shape)
    return cholesky_solve_unrolled_mat(h, eye, n)


def solve_psd(h: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve h x = b for small symmetric positive(-ish) definite h.

    Equivalent of the reference's Eigen::LDLT solves on 3x3/6x6 systems:
    an unrolled pivot-free Cholesky (see cholesky_solve_unrolled) with a
    scale-aware jitter for f32 robustness; sizes above 8 fall back to LU.
    """
    n = h.shape[-1]
    eye = jnp.eye(n, dtype=h.dtype)
    jitter = 1e-7 * jnp.maximum(jnp.trace(h, axis1=-2, axis2=-1) / n, 1e-12)
    hj = h + jitter[..., None, None] * eye
    if n == 3:
        # adjugate: measured 4.8e-5 max rel err on conditioned PSD batches,
        # ~25% cheaper than the unrolled Cholesky at [12288, 3, 3]
        return jnp.einsum("...ij,...j->...i", inv3x3(hj), b)
    if n <= 8:
        return cholesky_solve_unrolled(hj, b, n)
    return jnp.linalg.solve(hj, b)
