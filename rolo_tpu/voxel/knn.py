"""Brute-force dense k-NN + per-point covariance estimation.

Fixed-shape replacement for the reference's kd-tree covariance pass
(RotVGICP::calculate_covariances, rot_vgicp_impl.hpp:419-496): kd-trees are
pointer-chasing and have no fixed-shape form, so for feature-cloud sizes
(<=32k points) the neighbors come from a chunked dense distance matrix.
The distance tile is computed in one of two forms per callsite (see
knn_indices `form`): the matmul form |q|^2 + |x|^2 - 2 q.x for large
candidate sets with coarse gates (ICP, scan-to-submap binds), or the
cancellation-free elementwise difference form where sub-cm neighbor
ordering matters (covariance neighborhoods).

Covariance regularization mirrors rot_vgicp_impl.hpp:456-492: neighborhood
covariance (divided by k, reference line :456), then eigenvalue surgery
(PLANE -> (1, 1, 1e-3) etc.).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import sym3
from ..ops.eig3 import eigh3

PLANE = "plane"
MIN_EIG = "min_eig"
NORMALIZED_MIN_EIG = "normalized_min_eig"
FROBENIUS = "frobenius"
NONE = "none"


def _d2_chunk(qc: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """[C, N] squared distances between qc [C, 3] and points [N, 3],
    elementwise difference form (cancellation-free at lidar ranges)."""
    return (
        (qc[:, 0:1] - points[:, 0][None, :]) ** 2
        + (qc[:, 1:2] - points[:, 1][None, :]) ** 2
        + (qc[:, 2:3] - points[:, 2][None, :]) ** 2
    )


def knn_indices(
    query: jnp.ndarray,
    query_mask: jnp.ndarray,
    points: jnp.ndarray,
    points_mask: jnp.ndarray,
    k: int,
    chunk: int = 512,
    approximate: bool = False,
    recall_target: float = 0.95,
    form: str = "matmul",
) -> jnp.ndarray:
    """k nearest neighbors of each query among masked points.

    query [Q, 3], points [N, 3] -> idx [Q, k] int32. Invalid points are at
    infinite distance; invalid queries return arbitrary indices (mask
    downstream). Q must be a multiple of `chunk` or is padded internally.

    approximate=True swaps the row-wide `top_k` for `lax.approx_min_k`.
    On the GPU XLA lowers that to a radix sort of each row, on the CPU to
    an exact top-k: the result is exact and recall_target has no effect.

    form selects the distance-tile computation:
      "matmul" (default): |q|^2 - 2 q.x + |x|^2 — one small matmul per
        tile, at the process-wide matmul precision (rolo_tpu/__init__.py).
        At lidar coordinate scale its cancellation leaves ~5e-3 m^2
        absolute d2 noise in f32, far below the 0.3-1 m correspondence
        gates of the ICP / scan-to-submap consumers, and it is much
        cheaper than the elementwise form on large candidate sets (the
        loop ICP runs a [4k x 16k] k=1 kNN up to 100x per verification).
      "elementwise": per-coordinate difference form — cancellation-free,
        neighbor ordering f64-exact in practice. Use when sub-cm ordering
        matters (covariance neighborhoods; the estimate_cov6 selectors
        force this).
    """
    q = query.shape[0]
    n = points.shape[0]
    pad = (-q) % chunk
    if pad:
        query = jnp.pad(query, ((0, pad), (0, 0)))
    # masked slots may hold arbitrary padding (incl. NaN); NaN coordinates
    # would poison the whole distance row (NaN + inf = NaN) and leak into
    # every query's top-k, so zero them before they enter the matmul
    points = jnp.where(points_mask[:, None], points, 0.0)
    inf_row = jnp.where(points_mask, 0.0, jnp.inf)
    x2 = jnp.sum(points * points, axis=1)  # [N]

    def one_chunk(qc):
        if form == "elementwise":
            d2 = _d2_chunk(qc, points)
        else:
            d2 = (
                jnp.sum(qc * qc, axis=1, keepdims=True)
                - 2.0 * jnp.dot(qc, points.T, preferred_element_type=jnp.float32)
                + x2[None, :]
            )
        d2 = d2 + inf_row[None, :]
        if k == 1:
            # nearest-neighbor only (the ICP correspondence path, up to
            # 100x per loop/prior verification): a plain argmin row-reduce
            # is exact and fuses with the distance-tile producer, where
            # top_k/approx_min_k materialize the [C, N] tile in memory
            idx = jnp.argmin(d2, axis=1)[:, None]
        elif approximate:
            _, idx = jax.lax.approx_min_k(d2, k, recall_target=recall_target)
        else:
            _, idx = jax.lax.top_k(-d2, k)
        return idx.astype(jnp.int32)

    chunks = query.reshape(-1, chunk, 3)
    idx = jax.lax.map(one_chunk, chunks).reshape(-1, k)
    return idx[:q]


def regularize_covariance(cov: jnp.ndarray, method: str = PLANE) -> jnp.ndarray:
    """Eigenvalue surgery on [..., 3, 3] covariances (rot_vgicp_impl.hpp:458-492)."""
    if method == NONE:
        return cov
    if method == FROBENIUS:
        lam = 1e-3
        c = cov + lam * jnp.eye(3, dtype=cov.dtype)
        c_inv = jnp.linalg.inv(c)
        norm = jnp.linalg.norm(c_inv.reshape(*c_inv.shape[:-2], 9), axis=-1)
        return jnp.linalg.inv(c_inv / norm[..., None, None])
    # Symmetric PSD: SVD(U, s, V) == eigh up to ordering/signs; reference
    # reconstructs U diag(values) V^T which equals Q diag Q^T here.
    # Closed-form eig3 (ops/eig3.py) for batched 3x3s.
    eigval, eigvec = eigh3(cov)  # ascending
    if method == PLANE:
        values = jnp.broadcast_to(jnp.array([1e-3, 1.0, 1.0], cov.dtype), eigval.shape)
    elif method == MIN_EIG:
        values = jnp.maximum(eigval, 1e-3)
    elif method == NORMALIZED_MIN_EIG:
        values = jnp.maximum(eigval / jnp.maximum(eigval[..., -1:], 1e-12), 1e-3)
    else:
        raise ValueError(f"unknown regularization {method}")
    return jnp.einsum("...ij,...j,...kj->...ik", eigvec, values, eigvec)


@partial(jax.jit, static_argnames=("k", "method", "chunk", "selector"))
def estimate_cov6(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 20,
    method: str = PLANE,
    chunk: int = 512,
    selector: str = "moment",
    cand_xyz: jnp.ndarray = None,
    cand_mask: jnp.ndarray = None,
) -> jnp.ndarray:
    """Per-point regularized covariances from k-NN neighborhoods, SoA.

    Matches calculate_covariances (rot_vgicp_impl.hpp:419-496): the point
    itself is its own nearest neighbor, the neighborhood is mean-centered,
    cov = X X^T / k, then regularized. Returns [6, N] sym3 planes (the
    SoA layout the registration linearizers consume).

    selector:
      "moment" (default): gather-free. The kth-NN distance r_k comes from
        lax.approx_min_k on the elementwise distance chunk; neighborhood
        zeroth/first/second moments are then ONE extra matmul with the
        membership mask (d2 <= r_k) — no index materialization, no
        random gather. Membership is near-exact, but the covariance
        FORMULA E[xx] - mu mu^T carries an irreducible f32 cancellation
        at lidar coordinate scale: xx table entries ~2.5e3 are
        f32-quantized at ~1.5e-4 while cov entries are ~1e-4..1e-3,
        costing a few % median relative error pre-regularization vs the
        exact selector (tests/test_numeric_oracles.py pins the bound;
        bench.py gates the registration-level effect).
      "exact": lax.top_k indices + gather, bit-faithful to the reference's
        kd-tree k-NN — the oracle for tests.

    cand_xyz/cand_mask (optional): neighbor-candidate set when it differs
    from the query set — the SPMD point-sharded path queries a local shard
    against the all-gathered full cloud (parallel/spmd.py). Queries must be
    a subset of candidates for the self-neighbor property to hold. Defaults
    to (xyz, mask).
    """
    if cand_xyz is None:
        cand_xyz, cand_mask = xyz, mask
    n = xyz.shape[0]
    pad = (-n) % chunk
    # NaN padding in masked slots would poison d2 rows (NaN + inf = NaN)
    # and through them every query's threshold — zero masked coordinates
    # (queries too: a NaN query row would NaN its own moments)
    cand_xyz = jnp.where(cand_mask[:, None], cand_xyz, 0.0)
    xyz = jnp.where(mask[:, None], xyz, 0.0)
    xyz_p = jnp.pad(xyz, ((0, pad), (0, 0))) if pad else xyz
    inf_row = jnp.where(cand_mask, 0.0, jnp.inf)

    if selector == "exact":
        idx = knn_indices(xyz, mask, cand_xyz, cand_mask, k, chunk,
                          form="elementwise")
        neigh = cand_xyz[idx]  # [N, k, 3]
        centered = neigh - jnp.mean(neigh, axis=1, keepdims=True)
        cx, cy, cz = centered[..., 0], centered[..., 1], centered[..., 2]

        def comp(a, b):
            return jnp.sum(a * b, axis=1) / float(k)

        cov6 = jnp.stack(
            [comp(cx, cx), comp(cx, cy), comp(cx, cz), comp(cy, cy), comp(cy, cz), comp(cz, cz)],
            axis=0,
        )  # [6, N]
    else:
        # moments table: (1, x, y, z, xx, xy, xz, yy, yz, zz), invalid rows zero
        xc = jnp.concatenate(
            [
                jnp.ones((cand_xyz.shape[0], 1), cand_xyz.dtype),
                cand_xyz,
                cand_xyz[:, :1] * cand_xyz,
                cand_xyz[:, 1:2] * cand_xyz[:, 1:],
                cand_xyz[:, 2:] * cand_xyz[:, 2:],
            ],
            axis=1,
        ) * cand_mask[:, None]

        def one_chunk(qc):
            # elementwise distance tile (see _d2_chunk / knn_indices: the
            # matmul form's cancellation noise shifts the k-th-NN
            # membership threshold by ~14% median)
            d2 = _d2_chunk(qc, cand_xyz) + inf_row[None, :]
            # the k-th smallest distance is the membership radius; the
            # selection over-asks k + 12 so that the k-th value stays exact
            # even where approx_min_k is approximate (on the GPU and the
            # CPU it lowers to an exact selection)
            kk = min(k + 12, cand_xyz.shape[0])
            dk, _ = jax.lax.approx_min_k(d2, kk)
            rk = dk[:, k - 1:k]
            w = (d2 <= rk).astype(qc.dtype)
            # the moment sums are coordinate products at lidar scale: they
            # run at the process-wide matmul precision (rolo_tpu/__init__.py)
            return jnp.dot(w, xc, preferred_element_type=jnp.float32)

        mom = jax.lax.map(one_chunk, xyz_p.reshape(-1, chunk, 3)).reshape(-1, 10)[:n]
        cnt = jnp.maximum(mom[:, 0], 1.0)
        mu = (mom[:, 1:4] / cnt[:, None]).T  # [3, N]
        exx = (mom[:, 4:] / cnt[:, None]).T  # [6, N]
        # centered second moment, rescaled to the reference's sum/k
        cov6 = jnp.stack(
            [
                exx[0] - mu[0] * mu[0],
                exx[1] - mu[0] * mu[1],
                exx[2] - mu[0] * mu[2],
                exx[3] - mu[1] * mu[1],
                exx[4] - mu[1] * mu[2],
                exx[5] - mu[2] * mu[2],
            ],
            axis=0,
        ) * (cnt / float(k))[None, :]

    if method == PLANE:
        cov6 = sym3.plane_regularize(cov6)
    elif method != NONE:
        cov6 = sym3.from_mat(regularize_covariance(sym3.to_mat(cov6), method))
    ident = sym3.identity_like(cov6)
    return jnp.where(mask[None, :], cov6, ident)


@partial(jax.jit, static_argnames=("k", "method", "chunk"))
def estimate_covariances(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 20,
    method: str = PLANE,
    chunk: int = 512,
) -> jnp.ndarray:
    """Reference-shaped [N, 3, 3] covariance estimation (AoS wrapper over
    estimate_cov6 for oracles/tests; hot paths use estimate_cov6)."""
    return sym3.to_mat(estimate_cov6(xyz, mask, k=k, method=method, chunk=chunk))
