"""rot-GICP objective: correspondences, Mahalanobis weights, linearizations.

JAX re-design of RotVGICP
(/root/reference/include/rot_gicp/gicp/impl/rot_vgicp_impl.hpp). The
reference's per-correspondence OpenMP loops (update_correspondences :172-222,
linearize :225-290, so3_linearize :292-388, t3_linearize :498-607) become
fully vectorized array programs in **structure-of-arrays layout**: points
are [3, N] planes, symmetric matrices are [6, N] planes (ops/sym3), so the
innermost dimension is always the point axis (a [N, 3, 3] batch puts a
3-wide dim innermost, which layouts pad). This formulation runs the same
math in closed component form over the point axis. Everything is jit- and
vmap-safe, so thousands of
scan pairs batch across a device mesh.

Conventions follow the reference exactly:
  - residual e = voxel_mean_B - (R p_A + t)            (:256)
  - weight w = sqrt(voxel point count)                  (:258)
  - Mahalanobis M = (cov_B + R cov_A R^T)^{-1}          (:215-219)
  - SO(3) Jacobian J = skew(R p_A + t)                  (:347)
  - SE(3) Jacobian J = [skew(R p_A + t) | -I]           (:265-267)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..ops import sym3
from ..voxel.voxelmap import (
    VoxelMap,
    lookup_join,
    polar_bins,
    uniform_bins,
)
from ..ops.voxel_join import pack_polar, pack_uniform

# Neighbor offset tables (vmp_voxel.hpp:13-47).
OFFSETS = {
    "direct1": [(0, 0, 0)],
    "direct7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    "direct27": [(i - 1, j - 1, k - 1) for i in range(3) for j in range(3) for k in range(3)],
}


class GICPContext(NamedTuple):
    """Per-scan-pair registration problem: padded source cloud + target voxel map."""

    src_t: jnp.ndarray  # [3, N] source points (SoA)
    src_mask: jnp.ndarray  # [N]
    src_cov6: jnp.ndarray  # [6, N] source covariances (sym3 planes)
    vmap: VoxelMap  # target map
    polar_res: Optional[jnp.ndarray]  # [3] or None for uniform voxels
    resolution: float  # uniform voxel edge (used when polar_res is None)
    offsets: Tuple[Tuple[int, int, int], ...]  # static neighbor offsets


class Correspondences(NamedTuple):
    """Source-point -> target-voxel matches with precomputed Mahalanobis.

    SoA layout: every (neighbor offset, source point) pair is a
    correspondence slot, masked by `weight > 0`.
    """

    weight: jnp.ndarray  # [O, N] = sqrt(num_points) * found * src_mask
    mean_b: jnp.ndarray  # [O, 3, N]
    maha: jnp.ndarray  # [O, 6, N] sym3 planes


def make_context(
    src_xyz: jnp.ndarray,
    src_mask: jnp.ndarray,
    src_cov6: jnp.ndarray,
    vmap: VoxelMap,
    polar_res: Optional[jnp.ndarray] = None,
    resolution: float = 1.0,
    neighbor_search: str = "direct1",
) -> GICPContext:
    """src_xyz [N, 3] (converted to SoA internally); src_cov6 [6, N]."""
    return GICPContext(
        src_xyz.T, src_mask, src_cov6, vmap, polar_res, resolution,
        tuple(OFFSETS[neighbor_search]),
    )


def _transform(ctx: GICPContext, rot: jnp.ndarray, trans: jnp.ndarray) -> jnp.ndarray:
    """R p + t in SoA: [3, N]."""
    return rot @ ctx.src_t + trans[:, None]


def update_correspondences(
    ctx: GICPContext, rot: jnp.ndarray, trans: jnp.ndarray
) -> Correspondences:
    """Bin transformed source points into the target voxel map and precompute
    per-correspondence Mahalanobis matrices (rot_vgicp_impl.hpp:172-222)."""
    p = _transform(ctx, rot, trans)  # [3, N]
    n = p.shape[1]
    if ctx.polar_res is not None:
        b0, b1, b2 = polar_bins(p[0], p[1], p[2], ctx.polar_res)
    else:
        b0, b1, b2 = uniform_bins(p[0], p[1], p[2], ctx.resolution)

    packs = []
    for (o0, o1, o2) in ctx.offsets:
        c0, c1, c2 = b0 + o0, b1 + o1, b2 + o2
        coord = jnp.stack([c0, c1, c2], axis=-1)
        packs.append(
            pack_polar(coord) if ctx.polar_res is not None else pack_uniform(coord)
        )
    pack = jnp.stack(packs, axis=0)  # [O, N]
    o = pack.shape[0]

    found, num, mean_b, cov_b6 = lookup_join(ctx.vmap, pack.reshape(o * n))
    found = found.reshape(o, n) & ctx.src_mask[None, :]
    num = num.reshape(o, n)
    mean_b = mean_b.reshape(3, o, n).swapaxes(0, 1)  # [O, 3, N]
    cov_b6 = cov_b6.reshape(6, o, n).swapaxes(0, 1)  # [O, 6, N]

    # M = (cov_B + R cov_A R^T)^{-1}; 4th row/col of the reference matrices
    # are zero so the 3x3 block inverse is exact.
    rca = sym3.congruence(rot, ctx.src_cov6)  # [6, N]
    maha = sym3.inv(cov_b6 + rca[None, :, :])
    weight = jnp.where(found, jnp.sqrt(jnp.maximum(num, 0.0)), 0.0)
    return Correspondences(weight, mean_b, jnp.where(found[:, None, :], maha, 0.0))


def _skew_cols(p: jnp.ndarray):
    """Columns c_i of skew(p) for p [3, N]: c_i = d(skew(p) omega)/d omega_i.

    skew(p) = [[0, -pz, py], [pz, 0, -px], [-py, px, 0]] — its columns are
    c0 = (0, pz, -py), c1 = (-pz, 0, px), c2 = (py, -px, 0).
    """
    zero = jnp.zeros_like(p[0])
    c0 = jnp.stack([zero, p[2], -p[1]], axis=0)
    c1 = jnp.stack([-p[2], zero, p[0]], axis=0)
    c2 = jnp.stack([p[1], -p[0], zero], axis=0)
    return c0, c1, c2


def _dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Componentwise 3-vector dot over [..., 3, N] -> [..., N]."""
    return jnp.sum(a * b, axis=-2)


def _wsum(w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """sum over correspondences of w * x, both [O, N]."""
    return jnp.sum(w * x)


def compute_error(ctx: GICPContext, corr: Correspondences, rot, trans) -> jnp.ndarray:
    """sum_i w_i e_i^T M_i e_i (compute_error, rot_vgicp_impl.hpp:390-417)."""
    p = _transform(ctx, rot, trans)
    e = corr.mean_b - p[None, :, :]  # [O, 3, N]
    return _wsum(corr.weight, sym3.quad(corr.maha, e))


def so3_linearize(
    ctx: GICPContext, corr: Correspondences, rot, trans
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(error, H [3,3], b [3]) for the rotation-only step
    (so3_linearize, rot_vgicp_impl.hpp:292-388): J = skew(R p + t),
    H = sum w J^T M J, b = sum w J^T M e."""
    p = _transform(ctx, rot, trans)
    e = corr.mean_b - p[None, :, :]
    me = sym3.matvec(corr.maha, e)  # [O, 3, N]
    err = _wsum(corr.weight, _dot3(e, me))

    cols = _skew_cols(p)  # each [3, N], shared across offsets
    mc = [sym3.matvec(corr.maha, c[None, :, :]) for c in cols]  # [O, 3, N] each
    w = corr.weight
    h = jnp.stack(
        [
            jnp.stack([_wsum(w, _dot3(cols[i][None], mc[j])) for j in range(3)])
            for i in range(3)
        ]
    )
    b = jnp.stack([_wsum(w, _dot3(cols[i][None], me)) for i in range(3)])
    return err, h, b


def se3_linearize(
    ctx: GICPContext, corr: Correspondences, rot, trans
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(error, H [6,6], b [6]) for the full SE(3) step
    (linearize, rot_vgicp_impl.hpp:225-290). Tangent order: [omega, rho];
    J = [skew(R p + t) | -I]."""
    p = _transform(ctx, rot, trans)
    e = corr.mean_b - p[None, :, :]
    me = sym3.matvec(corr.maha, e)
    err = _wsum(corr.weight, _dot3(e, me))
    h, b = _se3_hb(corr.weight, corr.maha, p, me)
    return err, h, b


def _se3_hb(w, maha, p, me):
    """Shared [skew(p) | -I] Hessian/gradient assembly.

    H = [[S^T M S, -S^T M], [-M S, M]], b = [S^T me; -me] summed with w,
    where S = skew(p) and column i of S is c_i.
    """
    cols = _skew_cols(p)
    mc = [sym3.matvec(maha, c[None, :, :]) for c in cols]
    h_rr = [[_wsum(w, _dot3(cols[i][None], mc[j])) for j in range(3)] for i in range(3)]
    # -S^T M: entry (i, j) = -(c_i . M[:, j]) = -(mc_i)[j]  (M symmetric)
    h_rt = [[-_wsum(w, mc[i][:, j, :]) for j in range(3)] for i in range(3)]
    # M block summed
    idx6 = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    h_tt = [[_wsum(w, maha[:, idx6[i][j], :]) for j in range(3)] for i in range(3)]
    h_top = jnp.stack([jnp.stack(h_rr[i] + h_rt[i]) for i in range(3)])
    h_bot = jnp.stack(
        [jnp.stack([h_rt[j][i] for j in range(3)] + h_tt[i]) for i in range(3)]
    )
    h = jnp.concatenate([h_top, h_bot], axis=0)
    b_r = [_wsum(w, _dot3(cols[i][None], me)) for i in range(3)]
    b_t = [-_wsum(w, me[:, i, :]) for i in range(3)]
    b = jnp.stack(b_r + b_t)
    return h, b


def ct_linearize(
    ctx: GICPContext,
    corr: Correspondences,
    t: jnp.ndarray,
    init_guess: jnp.ndarray,
    last_t0: jnp.ndarray,
    interval_tn: jnp.ndarray,
    interval_tn_1: jnp.ndarray,
    ct_lambda: float,
    n_corr_override: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Continuous-time translation linearization
    (t3_linearize, rot_vgicp_impl.hpp:498-607).

    Residuals (source points are NOT rotated — the reference keeps input_ =
    the translation-propagated cloud, lidarOdometry.cpp:459,467):
      e  = mean_B - (p + t)
      ct = (g + t)/dt_n - last_t0/dt_{n-1}      (velocity continuity)
    weighted by w and lambda/N_corr.

    DELIBERATE FIX vs the reference: the shipped t3_linearize computes
    ct_error = (begin_A - transed_A)/dt_n - last/dt_{n-1}
             = -(g + t)/dt_n - last_t0/dt_{n-1}   (rot_vgicp_impl.hpp:548)
    i.e. it penalizes (g+t)/dt + last/dt' — pulling the current step toward
    the NEGATIVE of the previous one. The reference's own commented-out
    C_vel line (:552) and the paper's continuous-time model use the
    difference, which is what is implemented here; at high speed the
    shipped sign halves the recovered translation (empirically: 1.2 m true
    step -> ~0.52 m with the shipped sign, ~1.15 m with this one).
    The CT Jacobian is the exact d(ct)/dt = I/dt (the reference reuses the
    full [skew|-I]/dt point Jacobian at :578, whose rotation block is
    spurious for a residual independent of rotation).

    The reference's 4th homogeneous component of last_transform is
    uninitialized memory (Vector4d::col(3) on a 4x1 vector, :539-540); the
    intended 3-vector semantics are used here. Correspondences/Mahalanobis
    are reused from the rotation stage — the reference never re-binds them
    during the translation solve (:503-511); see lm_translation_rebind.
    """
    q = ctx.src_t + t[:, None]  # [3, N]
    e = corr.mean_b - q[None, :, :]
    ct = (init_guess + t) / interval_tn - last_t0 / interval_tn_1  # [3]
    # n_corr_override: global correspondence count when the point axis is
    # sharded over devices (parallel/spmd.py psums the local counts).
    if n_corr_override is None:
        n_corr = jnp.maximum(jnp.sum(corr.weight > 0), 1.0)
    else:
        n_corr = n_corr_override
    lam = ct_lambda / n_corr

    me = sym3.matvec(corr.maha, e)
    ct_b = jnp.broadcast_to(ct[None, :, None], corr.mean_b.shape)
    mct = sym3.matvec(corr.maha, ct_b)  # [O, 3, N]
    err = _wsum(corr.weight, _dot3(e, me)) + lam * _wsum(corr.weight, _dot3(ct_b, mct))

    h1, b1 = _se3_hb(corr.weight, corr.maha, q, me)
    # j2 = [0 | I/dt]: H2 = [[0, 0], [0, M/dt^2]], b2 = [0; M ct / dt]
    idx6 = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    m_sum = jnp.stack(
        [
            jnp.stack([_wsum(corr.weight, corr.maha[:, idx6[i][j], :]) for j in range(3)])
            for i in range(3)
        ]
    )
    h2 = jnp.zeros((6, 6), q.dtype).at[3:, 3:].set(m_sum / (interval_tn * interval_tn))
    b2 = jnp.zeros((6,), q.dtype).at[3:].set(
        jnp.stack([_wsum(corr.weight, mct[:, i, :]) for i in range(3)]) / interval_tn
    )
    return err, h1 + lam * h2, b1 + lam * b2


def ct_error(
    ctx: GICPContext,
    corr: Correspondences,
    t: jnp.ndarray,
    init_guess: jnp.ndarray,
    last_t0: jnp.ndarray,
    interval_tn: jnp.ndarray,
    interval_tn_1: jnp.ndarray,
    ct_lambda: float,
    n_corr_override: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """compute_t_error (rot_vgicp_impl.hpp:609-658), with the corrected
    velocity-continuity sign (see ct_linearize)."""
    q = ctx.src_t + t[:, None]
    e = corr.mean_b - q[None, :, :]
    ct = (init_guess + t) / interval_tn - last_t0 / interval_tn_1
    if n_corr_override is None:
        n_corr = jnp.maximum(jnp.sum(corr.weight > 0), 1.0)
    else:
        n_corr = n_corr_override
    lam = ct_lambda / n_corr
    ct_b = jnp.broadcast_to(ct[None, :, None], corr.mean_b.shape)
    return _wsum(corr.weight, sym3.quad(corr.maha, e)) + lam * _wsum(
        corr.weight, sym3.quad(corr.maha, ct_b)
    )
