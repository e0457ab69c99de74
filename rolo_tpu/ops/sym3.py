"""Structure-of-arrays symmetric 3x3 toolkit for the hot paths.

A batch of tiny matrices stored [N, 3, 3] puts a 3-wide dim innermost,
which accelerator layouts pad and vector units use poorly. This module
stores a symmetric 3x3 batch as six [..., N] component planes (N
innermost, no padding waste) and provides the closed-form ops the rot-GICP pipeline
needs: matvec, congruence R C R^T, adjugate inverse, quadratic forms, and
the smallest-eigenvector PLANE regularizer.

Component order everywhere: (m00, m01, m02, m11, m12, m22) — the upper
triangle row-major, matching the reference's Eigen covariance blocks
(rot_vgicp_impl.hpp:215-219) read symmetrically.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp

S00, S01, S02, S11, S12, S22 = range(6)


def from_mat(m: jnp.ndarray) -> jnp.ndarray:
    """[..., N, 3, 3] symmetric -> [..., 6, N] component planes."""
    comps = [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]]
    return jnp.stack(comps, axis=-2)


def to_mat(s: jnp.ndarray) -> jnp.ndarray:
    """[..., 6, N] -> [..., N, 3, 3] full symmetric matrices."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    row0 = jnp.stack([a, b, c], axis=-1)
    row1 = jnp.stack([b, d, e], axis=-1)
    row2 = jnp.stack([c, e, f], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matvec(s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """[..., 6, N] sym @ [..., 3, N] -> [..., 3, N]."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    return jnp.stack(
        [
            s[..., S00, :] * x + s[..., S01, :] * y + s[..., S02, :] * z,
            s[..., S01, :] * x + s[..., S11, :] * y + s[..., S12, :] * z,
            s[..., S02, :] * x + s[..., S12, :] * y + s[..., S22, :] * z,
        ],
        axis=-2,
    )


def quad(s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """v^T S v: [..., 6, N], [..., 3, N] -> [..., N]."""
    sv = matvec(s, v)
    return jnp.sum(v * sv, axis=-2)


def add(s: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return s + t


def identity_like(s: jnp.ndarray, scale=1.0) -> jnp.ndarray:
    """[..., 6, N] identity*scale with the same batch shape as s."""
    out = jnp.zeros_like(s)
    out = out.at[..., S00, :].set(scale)
    out = out.at[..., S11, :].set(scale)
    out = out.at[..., S22, :].set(scale)
    return out


def congruence(r: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """R S R^T for a single rotation R [3, 3] over a sym batch [..., 6, N].

    Used for the Mahalanobis precompute M = (C_B + R C_A R^T)^{-1}
    (rot_vgicp_impl.hpp:215-219).
    """
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    # rows of S as vectors applied to R^T: first T = R S  (3x3 per point)
    full = ((a, b, c), (b, d, e), (c, e, f))
    t = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            t[i][j] = r[i, 0] * full[0][j] + r[i, 1] * full[1][j] + r[i, 2] * full[2][j]
    # out = T R^T, keep upper triangle
    def entry(i, j):
        return t[i][0] * r[j, 0] + t[i][1] * r[j, 1] + t[i][2] * r[j, 2]

    return jnp.stack(
        [entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2)],
        axis=-2,
    )


def inv(s: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of a sym batch [..., 6, N] (the SoA
    twin of ops.linalg.inv3x3)."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, jnp.where(det < 0, -1e-30, 1e-30), det)
    return jnp.stack([co00, co01, co02, co11, co12, co22], axis=-2) * inv_det[..., None, :]


def eigvals(s: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(lam_min, lam_mid, lam_max) of a sym batch [..., 6, N] — the SoA
    twin of ops.eig3.eigvalsh3 (trigonometric closed form)."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    q = (a + d + f) / 3.0
    aq, dq, fq = a - q, d - q, f - q
    p2 = (aq * aq + dq * dq + fq * fq + 2.0 * (b * b + c * c + e * e)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    # det((S - qI) / p)
    b00, b01, b02, b11, b12, b22 = aq / p, b / p, c / p, dq / p, e / p, fq / p
    det_b = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(det_b / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    lam_max = q + 2.0 * p * jnp.cos(phi)
    lam_min = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_max - lam_min
    isotropic = p2 < 1e-28
    lam_max = jnp.where(isotropic, q, lam_max)
    lam_mid = jnp.where(isotropic, q, lam_mid)
    lam_min = jnp.where(isotropic, q, lam_min)
    return lam_min, lam_mid, lam_max


def smallest_eigvec(s: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue, [..., 3, N].

    Cross products of rows of (S - lam_min I), largest-norm pick, with an
    axis fallback for (near-)isotropic input — SoA twin of
    ops.eig3._eigenvector.
    """
    lam_min, _, _ = eigvals(s)
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    m00, m11, m22 = a - lam_min, d - lam_min, f - lam_min
    # rows of M: r0 = (m00, b, c), r1 = (b, m11, e), r2 = (c, e, m22)
    def cross(u, v):
        return (
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        )

    r0 = (m00, b, c)
    r1 = (b, m11, e)
    r2 = (c, e, m22)
    c01 = cross(r0, r1)
    c02 = cross(r0, r2)
    c12 = cross(r1, r2)

    def norm2(u):
        return u[0] * u[0] + u[1] * u[1] + u[2] * u[2]

    n01, n02, n12 = norm2(c01), norm2(c02), norm2(c12)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = [jnp.where(best12, c12[i], jnp.where(best02, c02[i], c01[i])) for i in range(3)]
    n = norm2(v)
    m2 = jnp.maximum(
        (m00 * m00 + m11 * m11 + m22 * m22 + 2.0 * (b * b + c * c + e * e)) ** 2, 1e-30
    )
    degenerate = n / m2 < 1e-12
    v = [jnp.where(degenerate, 1.0 if i == 0 else 0.0, v[i]) for i in range(3)]
    n = jnp.sqrt(jnp.maximum(norm2(v), 1e-30))
    return jnp.stack([v[0] / n, v[1] / n, v[2] / n], axis=-2)


def plane_regularize(s: jnp.ndarray, eps: float = 1e-3) -> jnp.ndarray:
    """PLANE covariance surgery, SoA: Q diag(eps, 1, 1) Q^T (ascending
    eigenvalues) == I - (1 - eps) q0 q0^T where q0 is the smallest
    eigenvector (rot_vgicp_impl.hpp:458-492 with values (1, 1, 1e-3)).
    Needs only one eigenvector — no full decomposition."""
    q0 = smallest_eigvec(s)
    x, y, z = q0[..., 0, :], q0[..., 1, :], q0[..., 2, :]
    w = 1.0 - eps
    return jnp.stack(
        [1.0 - w * x * x, -w * x * y, -w * x * z, 1.0 - w * y * y, -w * y * z, 1.0 - w * z * z],
        axis=-2,
    )
