"""Closed-form symmetric 3x3 eigendecomposition.

XLA's `jnp.linalg.eigh` lowers to an iterative QR/Jacobi loop, a poor fit
for large batches of tiny matrices. Every 3x3 spectral op in this codebase
(covariance regularization rot_vgicp_impl.hpp:458-492, corner-line PCA
backMapping.cpp:741-762, ground plane fits pose_solver.cpp:326-353) runs
over 10^4..10^5 matrices per scan, so they use this analytic path instead:
eigenvalues by the trigonometric solution of the characteristic polynomial,
eigenvectors by cross products of (A - lambda I) rows — all elementwise VPU
ops, batchable to any shape.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp


def eigvalsh3(a: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric [..., 3, 3], ascending (matches
    jnp.linalg.eigvalsh ordering)."""
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    a_q = a - q[..., None, None] * jnp.eye(3, dtype=a.dtype)
    p2 = jnp.sum(a_q * a_q, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    b = a_q / p[..., None, None]
    det_b = (
        b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
        - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
        + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0])
    )
    r = jnp.clip(det_b / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    lam_max = q + 2.0 * p * jnp.cos(phi)
    lam_min = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lam_mid = 3.0 * q - lam_max - lam_min
    # scalar-matrix case (p ~ 0): all eigenvalues = q
    isotropic = p2 < 1e-28
    lam_max = jnp.where(isotropic, q, lam_max)
    lam_mid = jnp.where(isotropic, q, lam_mid)
    lam_min = jnp.where(isotropic, q, lam_min)
    return jnp.stack([lam_min, lam_mid, lam_max], axis=-1)


def _eigenvector(a: jnp.ndarray, lam: jnp.ndarray, fallback: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of symmetric a for eigenvalue lam: the largest cross
    product of rows of (a - lam I); `fallback` [..., 3] used when the
    eigenvalue is (near-)degenerate and every cross product vanishes."""
    m = a - lam[..., None, None] * jnp.eye(3, dtype=a.dtype)
    c01 = jnp.cross(m[..., 0, :], m[..., 1, :])
    c02 = jnp.cross(m[..., 0, :], m[..., 2, :])
    c12 = jnp.cross(m[..., 1, :], m[..., 2, :])
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = jnp.where(best12[..., None], c12, jnp.where(best02[..., None], c02, c01))
    n = jnp.sum(v * v, axis=-1)
    # scale-aware degeneracy test: cross products vanish relative to m^2
    m2 = jnp.maximum(jnp.sum(m * m, axis=(-2, -1)) ** 2, 1e-30)
    degenerate = n / m2 < 1e-12
    v = jnp.where(degenerate[..., None], fallback, v)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def eigh3(a: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3] with
    column k the eigenvector of eigenvalue k) for symmetric [..., 3, 3] —
    drop-in for jnp.linalg.eigh on symmetric 3x3 input."""
    lam = eigvalsh3(a)
    ex = jnp.zeros_like(lam).at[..., 0].set(1.0)
    v_max = _eigenvector(a, lam[..., 2], ex)
    # second vector: eigenvector of lam_min computed in the plane
    # orthogonal to v_max for stability; fallback = anything not parallel
    # to v_max
    alt = jnp.zeros_like(lam).at[..., 1].set(1.0)
    parallel = jnp.abs(v_max[..., 0]) > 0.9
    fb = jnp.where(parallel[..., None], alt, ex)
    fb = fb - jnp.sum(fb * v_max, axis=-1, keepdims=True) * v_max
    v_min = _eigenvector(a, lam[..., 0], fb)
    # re-orthogonalize (degenerate pairs can drift) and complete the triad
    v_min = v_min - jnp.sum(v_min * v_max, axis=-1, keepdims=True) * v_max
    v_min = v_min / jnp.maximum(jnp.linalg.norm(v_min, axis=-1, keepdims=True), 1e-30)
    v_mid = jnp.cross(v_max, v_min)
    vecs = jnp.stack([v_min, v_mid, v_max], axis=-1)
    return lam, vecs


def spectral_rebuild(a: jnp.ndarray, new_vals) -> jnp.ndarray:
    """Q diag(new_vals(lam)) Q^T — the covariance-regularization primitive.
    `new_vals` maps eigenvalues [..., 3] (ascending) to replacements."""
    lam, q = eigh3(a)
    vals = new_vals(lam)
    return jnp.einsum("...ij,...j,...kj->...ik", q, vals, q)
