"""Experimental multi-neighbor GICP (point cloud to point cloud, k target
neighbors per source point).

JAX equivalent of the reference's experimental FastGICPMultiPoints
(/root/reference/include/rot_gicp/gicp/experimental/fast_gicp_mp.hpp — kept
under experimental/ and not built into any target; provided here for
component parity). Instead of one voxel correspondence per source point,
each source point is matched to its k nearest *points* in the target cloud
and every (point, neighbor) pair contributes a Mahalanobis-weighted
residual.

Design: the kd-tree neighbor search becomes the chunked brute-force
k-NN (voxel.knn.knn_indices) and the per-neighbor constraint set maps
directly onto the SoA Correspondences layout [O=k, N] that the production
rot-GICP linearizers already consume — so the multi-point variant reuses
se3_linearize/compute_error verbatim.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import sym3
from ..voxel.knn import estimate_cov6, knn_indices
from . import gicp
from .gicp import Correspondences, GICPContext
from .lm import LMResult, lm_register_se3  # noqa: F401  (re-export context)
from . import lm as _lm


class MultiPointProblem(NamedTuple):
    """Padded source/target clouds with per-point covariances (sym3 SoA)."""

    src_xyz: jnp.ndarray  # [N, 3]
    src_mask: jnp.ndarray  # [N]
    src_cov6: jnp.ndarray  # [6, N]
    tgt_xyz: jnp.ndarray  # [M, 3]
    tgt_mask: jnp.ndarray  # [M]
    tgt_cov6: jnp.ndarray  # [6, M]


def make_problem(
    src_xyz: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_xyz: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    k_cov: int = 20,
    method: str = "plane",
) -> MultiPointProblem:
    return MultiPointProblem(
        src_xyz,
        src_mask,
        estimate_cov6(src_xyz, src_mask, k=k_cov, method=method),
        tgt_xyz,
        tgt_mask,
        estimate_cov6(tgt_xyz, tgt_mask, k=k_cov, method=method),
    )


def _bind_multipoint(
    prob: MultiPointProblem,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    k: int,
    max_dist: float,
) -> Correspondences:
    """k-NN correspondences of the transformed source against target points.

    weight = 1/k per neighbor (each source point contributes one unit of
    influence split across its neighborhood); neighbors beyond `max_dist`
    are masked out."""
    p = (prob.src_xyz @ rot.T) + trans  # [N, 3]
    idx = knn_indices(p, prob.src_mask, prob.tgt_xyz, prob.tgt_mask, k)  # [N, k]
    neigh = prob.tgt_xyz[idx]  # [N, k, 3]
    d2 = jnp.sum((neigh - p[:, None, :]) ** 2, axis=-1)  # [N, k]
    ok = (
        prob.src_mask[:, None]
        & prob.tgt_mask[idx]
        & (d2 <= max_dist * max_dist)
    )  # [N, k]

    mean_b = jnp.transpose(neigh, (1, 2, 0))  # [k, 3, N]
    cov_b6 = prob.tgt_cov6[:, idx.T]  # [6, k, N] -> slot axis first
    cov_b6 = jnp.swapaxes(cov_b6, 0, 1)  # [k, 6, N]
    rca = sym3.congruence(rot, prob.src_cov6)  # [6, N]
    maha = sym3.inv(cov_b6 + rca[None, :, :])  # [k, 6, N]
    okT = ok.T  # [k, N]
    weight = jnp.where(okT, 1.0 / float(k), 0.0)
    return Correspondences(weight, mean_b, jnp.where(okT[:, None, :], maha, 0.0))


@partial(jax.jit, static_argnames=("k", "max_outer", "max_inner"))
def register_multipoint(
    prob: MultiPointProblem,
    init_rot: jnp.ndarray,
    init_trans: jnp.ndarray,
    k: int = 8,
    max_dist: float = 2.0,
    max_outer: int = _lm.MAX_OUTER,
    max_inner: int = _lm.MAX_INNER,
    rot_eps: float = _lm.ROTATION_EPS,
    trans_eps: float = _lm.TRANSFORM_EPS,
    init_lambda_factor: float = _lm.INIT_LAMBDA_FACTOR,
) -> LMResult:
    """SE(3) LM over the multi-neighbor GICP objective. Correspondences are
    re-bound at every outer linearization, like the production rot-GICP."""
    from ..geometry import se3

    dtype = init_rot.dtype
    # ctx only feeds src points/mask into the shared linearizers; the voxel
    # map slot is unused on this path.
    ctx = GICPContext(
        prob.src_xyz.T, prob.src_mask, prob.src_cov6, None, None, 1.0, ((0, 0, 0),)
    )

    def small_delta(delta):
        d_rot, d_trans = delta
        return _lm._rot_small(d_rot, rot_eps) & _lm._trans_small(d_trans, trans_eps)

    def outer_cond(s):
        it, _, _, lam, conv, failed, _, _ = s
        return (it < max_outer) & ~conv & ~failed

    def outer_body(s):
        it, rot, trans, lam, conv, failed, _, _ = s
        corr = _bind_multipoint(prob, rot, trans, k, max_dist)
        y0, h, b = gicp.se3_linearize(ctx, corr, rot, trans)
        lam = jnp.where(lam < 0, init_lambda_factor * jnp.max(jnp.abs(jnp.diag(h))), lam)

        def try_step(d):
            dT = se3.exp(d)
            cand_rot = dT.rot @ rot
            cand_trans = dT.rot @ trans + dT.trans
            yi = gicp.compute_error(ctx, corr, cand_rot, cand_trans)
            return (cand_rot, cand_trans), (dT.rot, dT.trans), yi

        cond, body = _lm._lm_inner(h, b, y0, lam, try_step, small_delta, max_inner)
        init = (
            0, lam, 2.0, (rot, trans), jnp.array(False), jnp.array(False),
            (jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype)),
        )
        _, lam, _, (rot, trans), done, _, delta = jax.lax.while_loop(cond, body, init)
        return (it + 1, rot, trans, lam, done & small_delta(delta), ~done, h, y0)

    state = (
        0, init_rot, init_trans, jnp.asarray(-1.0, dtype),
        jnp.array(False), jnp.array(False),
        jnp.eye(6, dtype=dtype), jnp.asarray(0.0, dtype),
    )
    it, rot, trans, lam, conv, failed, h, err = jax.lax.while_loop(
        outer_cond, outer_body, state
    )
    return LMResult(rot, trans, h, err, it, conv, failed)
