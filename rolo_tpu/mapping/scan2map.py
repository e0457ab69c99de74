"""Scan-to-submap Gauss-Newton alignment with LOAM point-to-line /
point-to-plane factors and degeneracy projection.

JAX re-design of backMapping's scan2MapOptimization
(/root/reference/src/backMapping.cpp:681-1068):
  - cornerOptimization (:720-824): 5-NN + PCA line fit -> point-to-line
    residual with the 1 - 0.9|d| weight,
  - surfOptimization (:827-902): 5-NN + least-squares plane fit (A x = -1)
    -> point-to-plane residual,
  - LMOptimization (:929-1057): 6-dof Gauss-Newton on (roll,pitch,yaw,x,y,z)
    with eigenvalue-thresholded degeneracy projection (:1006-1035).

kd-trees are replaced by chunked brute-force 5-NN; the per-point
camera-coordinate trig Jacobian of the reference is replaced by the
equivalent analytic dR/d(angle) contraction (same derivative, lidar frame).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry import so3
from ..geometry.se3 import SE3
from ..ops.eig3 import eigh3
from ..ops.linalg import solve_psd
from ..pointcloud.cloud import PaddedCloud
from ..voxel.knn import knn_indices


class FactorSet(NamedTuple):
    """Per-point linearized constraints: direction [N,3], residual [N],
    point (sensor frame) [N,3], valid [N]."""

    direction: jnp.ndarray
    residual: jnp.ndarray
    point: jnp.ndarray
    valid: jnp.ndarray


def _rpy_matrices(rpy: jnp.ndarray):
    """R and dR/d(roll), dR/d(pitch), dR/d(yaw) for R = Rz Ry Rx."""

    def rot_of(v):
        return so3.rpy_to_matrix(v[0], v[1], v[2])

    r = rot_of(rpy)
    dr = jax.jacfwd(rot_of)(rpy)  # [3, 3, 3] -> dR[i,j]/drpy[k]
    return r, dr


class CornerBindings(NamedTuple):
    """Frozen point-to-line correspondences: line (center, direction) per
    corner point + validity. Geometry depends only on the bound submap
    neighbors, so it is constant between rebinds."""

    center: jnp.ndarray  # [N, 3]
    u: jnp.ndarray  # [N, 3] line direction
    valid: jnp.ndarray  # [N]


class SurfBindings(NamedTuple):
    """Frozen point-to-plane correspondences: unit normal + offset."""

    pa: jnp.ndarray  # [N, 3]
    pd: jnp.ndarray  # [N]
    valid: jnp.ndarray  # [N]


def nn_candidates(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    submap: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    n_cand: int,
    chunk: int = 512,
    approx_knn: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-point candidate neighbor set: the n_cand nearest submap points at
    the current pose, plus the median candidate-set radius (distance to the
    farthest candidate over valid points). Computed at bind time; later
    rebinds re-rank only these candidates (the pose moves sub-cm between
    mapping refinement steps, so the true 5-NN stays inside the candidate
    set) — this replaces the reference's full kd-tree re-search every
    iteration (backMapping.cpp:736, :843) with one full search + cheap
    re-ranks. The radius lets the solver detect when the pose has moved far
    enough that the frozen candidate set may no longer contain the true
    5-NN (stale-candidate guard)."""
    world = jnp.einsum("ij,nj->ni", rot, pts) + trans
    idx = knn_indices(world, mask, submap.xyz, submap.mask, n_cand, chunk,
                      approximate=approx_knn)
    far = submap.xyz[idx[:, -1]]  # the n_cand-th nearest at bind time
    d = jnp.linalg.norm(far - world, axis=-1)
    d = jnp.where(mask & submap.mask[idx[:, -1]], d, jnp.nan)
    radius = jnp.nan_to_num(jnp.nanmedian(d), nan=1.0)
    return idx, radius


def _top5_from_candidates(
    world: jnp.ndarray, cand_idx: jnp.ndarray, submap: PaddedCloud
) -> jnp.ndarray:
    """Exact 5-NN among the candidate set: [N, C] distances + tiny top-k."""
    cand = submap.xyz[cand_idx]  # [N, C, 3]
    d2 = jnp.sum((cand - world[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(submap.mask[cand_idx], d2, jnp.inf)
    _, sel = jax.lax.top_k(-d2, 5)  # [N, 5]
    return jnp.take_along_axis(cand_idx, sel, axis=1)


def corner_bind(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    submap: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    chunk: int = 512,
    approx_knn: bool = False,
    cand_idx: jnp.ndarray = None,
) -> CornerBindings:
    """5-NN + PCA line fit (cornerOptimization, backMapping.cpp:720-824) —
    the expensive binding half, done once per rebind round. With cand_idx
    [N, C] the 5-NN is re-ranked from the candidate set instead of searched
    over the full submap."""
    world = jnp.einsum("ij,nj->ni", rot, pts) + trans
    if cand_idx is not None:
        idx = _top5_from_candidates(world, cand_idx, submap)
    else:
        idx = knn_indices(world, mask, submap.xyz, submap.mask, 5, chunk, approximate=approx_knn)
    neigh = submap.xyz[idx]  # [N, 5, 3]
    d2 = jnp.sum((neigh - world[:, None, :]) ** 2, axis=-1)
    near_ok = jnp.max(d2, axis=1) < 1.0  # pointSearchSqDis[4] < 1.0

    center = jnp.mean(neigh, axis=1)
    centered = neigh - center[:, None, :]
    cov = jnp.einsum("nki,nkj->nij", centered, centered) / 5.0
    eigval, eigvec = eigh3(cov)  # ascending (closed form; see ops/eig3.py)
    line_ok = eigval[:, 2] > 3.0 * eigval[:, 1]  # matD1(0,0) > 3*matD1(0,1)
    u = eigvec[:, :, 2]  # line direction (largest eigenvalue)
    return CornerBindings(center, u, mask & near_ok & line_ok)


def corner_eval(
    b: CornerBindings, pts: jnp.ndarray, rot: jnp.ndarray, trans: jnp.ndarray
) -> FactorSet:
    """Residual/direction of the frozen lines at the current pose — the
    cheap half, every GN iteration."""
    world = jnp.einsum("ij,nj->ni", rot, pts) + trans
    rel = world - b.center
    along = jnp.einsum("ni,ni->n", rel, b.u)
    perp = rel - along[:, None] * b.u
    ld2 = jnp.linalg.norm(perp, axis=-1)
    direction = perp / jnp.maximum(ld2, 1e-9)[:, None]
    s = 1.0 - 0.9 * jnp.abs(ld2)
    valid = b.valid & (s > 0.1)
    return FactorSet(s[:, None] * direction, s * ld2, pts, valid)


def surf_bind(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    submap: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    chunk: int = 512,
    approx_knn: bool = False,
    cand_idx: jnp.ndarray = None,
) -> SurfBindings:
    """5-NN + least-squares plane fit (surfOptimization,
    backMapping.cpp:827-902) — binding half."""
    world = jnp.einsum("ij,nj->ni", rot, pts) + trans
    if cand_idx is not None:
        idx = _top5_from_candidates(world, cand_idx, submap)
    else:
        idx = knn_indices(world, mask, submap.xyz, submap.mask, 5, chunk, approximate=approx_knn)
    neigh = submap.xyz[idx]
    d2 = jnp.sum((neigh - world[:, None, :]) ** 2, axis=-1)
    near_ok = jnp.max(d2, axis=1) < 1.0

    # plane fit: solve A n = -1 (5x3 least squares via normal equations).
    # solve_psd is the unrolled closed-form Cholesky — a jnp.linalg.solve
    # here lowers to XLA's batched tiny-matrix LU kernel, which dominated
    # the scan2map bind at [12288,3,3] on the accelerator it was tuned on.
    ata = jnp.einsum("nki,nkj->nij", neigh, neigh)
    atb = -jnp.sum(neigh, axis=1)
    n_vec = solve_psd(ata, atb)  # [N, 3]
    norm = jnp.linalg.norm(n_vec, axis=-1)
    pa = n_vec / jnp.maximum(norm, 1e-9)[:, None]
    pd = 1.0 / jnp.maximum(norm, 1e-9)
    # plane quality: every neighbor within 0.2 m
    plane_err = jnp.abs(jnp.einsum("nki,ni->nk", neigh, pa) + pd[:, None])
    plane_ok = jnp.max(plane_err, axis=1) <= 0.2
    return SurfBindings(pa, pd, mask & near_ok & plane_ok)


def surf_eval(
    b: SurfBindings, pts: jnp.ndarray, rot: jnp.ndarray, trans: jnp.ndarray
) -> FactorSet:
    world = jnp.einsum("ij,nj->ni", rot, pts) + trans
    pd2 = jnp.einsum("ni,ni->n", world, b.pa) + b.pd
    origin_range = jnp.linalg.norm(pts, axis=-1)
    s = 1.0 - 0.9 * jnp.abs(pd2) / jnp.sqrt(jnp.sqrt(jnp.maximum(origin_range, 1e-6)))
    valid = b.valid & (s > 0.1)
    return FactorSet(s[:, None] * b.pa, s * pd2, pts, valid)


def corner_factors(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    submap: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    chunk: int = 512,
) -> FactorSet:
    """Point-to-line factors in one shot (bind + eval at the same pose —
    exactly the reference's per-iteration cornerOptimization)."""
    return corner_eval(corner_bind(pts, mask, submap, rot, trans, chunk), pts, rot, trans)


def surf_factors(
    pts: jnp.ndarray,
    mask: jnp.ndarray,
    submap: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    chunk: int = 512,
) -> FactorSet:
    """Point-to-plane factors in one shot (surfOptimization)."""
    return surf_eval(surf_bind(pts, mask, submap, rot, trans, chunk), pts, rot, trans)


class Scan2MapResult(NamedTuple):
    rot: jnp.ndarray
    trans: jnp.ndarray
    rpy: jnp.ndarray
    degenerate: jnp.ndarray
    iterations: jnp.ndarray
    num_factors: jnp.ndarray
    converged: jnp.ndarray


def _gn_normal_eqs(factors: FactorSet, rpy: jnp.ndarray, xyz: jnp.ndarray):
    """Assemble AtA/AtB (LMOptimization, backMapping.cpp:963-1003).

    Column order [roll, pitch, yaw, x, y, z]; rotation columns are
    coeff . (dR/dangle @ p) — algebraically identical to the reference's
    camera-frame trig expansion (:975-986)."""
    _, dr = _rpy_matrices(rpy)
    # dr: [3, 3, 3] with dr[i, j, k] = dR[i,j]/drpy[k]
    jrot = jnp.einsum("ni,ijk,nj->nk", factors.direction, dr, factors.point)  # [N, 3]
    jac = jnp.concatenate([jrot, factors.direction], axis=-1)  # [N, 6]
    w = factors.valid.astype(jac.dtype)
    ata = jnp.einsum("n,ni,nj->ij", w, jac, jac)
    atb = jnp.einsum("n,ni,n->i", w, jac, -factors.residual)
    return ata, atb


@partial(jax.jit, static_argnames=("max_iterations", "chunk", "rebind_every", "approx_knn", "n_candidates"))
def scan2map_optimize(
    rpy0: jnp.ndarray,
    xyz0: jnp.ndarray,
    corner_pts: jnp.ndarray,
    corner_mask: jnp.ndarray,
    surf_pts: jnp.ndarray,
    surf_mask: jnp.ndarray,
    submap_corner: PaddedCloud,
    submap_surf: PaddedCloud,
    max_iterations: int = 30,
    degeneracy_threshold: float = 100.0,
    min_factors: int = 50,
    chunk: int = 512,
    rebind_every: int = 5,
    approx_knn: bool = False,
    n_candidates: int = 16,
) -> Scan2MapResult:
    """Iterative GN scan-to-submap alignment (scan2MapOptimization loop,
    backMapping.cpp:692-705). rpy0/xyz0: initial guess (transformTobeMapped
    order [roll,pitch,yaw] / [x,y,z]).

    rebind_every: iterations between correspondence re-searches. The
    reference re-runs the 5-NN every iteration (rebind_every=1); the kNN
    dominates the iteration cost while the pose moves sub-cm between
    mapping refinement steps, so binding every few iterations saves most
    of it at equal linearization count. The line/plane fits are
    frozen with their bindings (they depend only on the bound neighbors).

    n_candidates: when > 5, the full-submap search runs ONCE at the initial
    pose with this many neighbors per point; every rebind then re-ranks the
    candidate set ([N, C] distances + tiny top-k) instead of searching the
    submap again — rebinds become ~free and the whole solve costs one full
    k-NN + max_iterations cheap evals. 0 disables candidate reuse (full
    search every rebind — the reference's exact behavior)."""
    dtype = xyz0.dtype
    eye6 = jnp.eye(6, dtype=dtype)
    use_cand = bool(n_candidates) and n_candidates > 5

    def full_cand(rpy, xyz):
        """Full-submap candidate search at the given pose + its radius +
        the anchor pose it was bound at."""
        rot = so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2])
        cand_c, rad_c = nn_candidates(corner_pts, corner_mask, submap_corner,
                                      rot, xyz, n_candidates, chunk, approx_knn)
        cand_s, rad_s = nn_candidates(surf_pts, surf_mask, submap_surf,
                                      rot, xyz, n_candidates, chunk, approx_knn)
        return cand_c, cand_s, jnp.minimum(rad_c, rad_s), rpy, xyz

    if use_cand:
        cand0 = full_cand(rpy0, xyz0)
    else:
        cand0 = None

    def rebind(rpy, xyz, cand_c, cand_s):
        rot = so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2])
        cb = corner_bind(corner_pts, corner_mask, submap_corner, rot, xyz, chunk,
                         approx_knn, cand_idx=cand_c)
        sb = surf_bind(surf_pts, surf_mask, submap_surf, rot, xyz, chunk,
                       approx_knn, cand_idx=cand_s)
        return cb, sb

    # With a candidate set, a rebind is a cheap re-rank — run it every
    # iteration (the reference's exact per-iteration re-search semantics,
    # restricted to the candidates). Without one, rebind on the schedule.
    def body(state):
        rpy, xyz, cb, sb, cand, proj, degen, it, conv, nfac = state
        if use_cand:
            # stale-candidate guard (ADVICE round-2): if the pose has moved
            # a large fraction of the candidate-set radius since the set
            # was bound, the true 5-NN can fall outside it while stale
            # candidates still pass the <1 m near_ok gate — re-run the
            # full-submap search at the current pose. 30 m converts the
            # rotation delta to a displacement bound at lidar range.
            cand_c, cand_s, radius, a_rpy, a_xyz = cand
            # per-axis wrap to (-pi, pi] (ADVICE round-3): a yaw crossing
            # +-pi between bind and iteration must not read as ~2*pi moved
            drpy = rpy - a_rpy
            drpy = jnp.arctan2(jnp.sin(drpy), jnp.cos(drpy))
            moved = jnp.linalg.norm(xyz - a_xyz) + 30.0 * jnp.linalg.norm(drpy)
            cand = jax.lax.cond(
                moved > 0.5 * radius,
                lambda: full_cand(rpy, xyz),
                lambda: cand,
            )
            cand_c, cand_s = cand[0], cand[1]
        else:
            cand_c = cand_s = None
        rebound_now = (it > 0) & (use_cand | (it % rebind_every == 0))
        cb, sb = jax.lax.cond(
            rebound_now,
            lambda: rebind(rpy, xyz, cand_c, cand_s),
            lambda: (cb, sb),
        )
        fresh = rebound_now | (it == 0)
        rot = so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2])
        cf = corner_eval(cb, corner_pts, rot, xyz)
        sf = surf_eval(sb, surf_pts, rot, xyz)
        nfac = jnp.sum(cf.valid) + jnp.sum(sf.valid)

        ata_c, atb_c = _gn_normal_eqs(cf, rpy, xyz)
        ata_s, atb_s = _gn_normal_eqs(sf, rpy, xyz)
        ata = ata_c + ata_s
        atb = atb_c + atb_s
        x = solve_psd(ata, atb)

        # degeneracy projection on the first iteration (:1006-1028)
        def first_proj():
            e, v = jnp.linalg.eigh(ata)  # ascending eigenvalues, columns
            keep = (e >= degeneracy_threshold).astype(dtype)
            p = jnp.einsum("ik,k,jk->ij", v, keep, v)
            return p, jnp.any(e < degeneracy_threshold)

        proj, degen = jax.lax.cond(
            it == 0, first_proj, lambda: (proj, degen)
        )
        x = proj @ x

        enough = nfac >= min_factors  # LMOptimization :949-951
        x = jnp.where(enough, x, 0.0)
        rpy = rpy + x[:3]
        xyz = xyz + x[3:]

        delta_r = jnp.rad2deg(jnp.linalg.norm(x[:3]))
        delta_t = 100.0 * jnp.linalg.norm(x[3:])
        # only a FRESHLY-bound linearization may declare convergence: a tiny
        # step against stale correspondences means the pose stopped moving
        # relative to frozen lines/planes, not that it is aligned
        conv = ((delta_r < 0.05) & (delta_t < 0.05) & fresh) | ~enough
        return (rpy, xyz, cb, sb, cand, proj, degen, it + 1, conv, nfac)

    def cond(state):
        *_, it, conv, _ = state
        return (it < max_iterations) & ~conv

    if use_cand:
        cb0, sb0 = rebind(rpy0, xyz0, cand0[0], cand0[1])
    else:
        cb0, sb0 = rebind(rpy0, xyz0, None, None)
    state = (
        rpy0, xyz0, cb0, sb0, cand0, eye6, jnp.array(False), jnp.asarray(0, jnp.int32),
        jnp.array(False), jnp.asarray(0, jnp.int32),
    )
    rpy, xyz, _, _, _, _, degen, it, conv, nfac = jax.lax.while_loop(cond, body, state)
    rot = so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2])
    return Scan2MapResult(rot, xyz, rpy, degen, it, nfac, conv)


def constrain_transform(
    rpy: jnp.ndarray, xyz: jnp.ndarray, rotation_tolerance: float, z_tolerance: float
):
    """transformUpdate (backMapping.cpp:1060-1068): clamp roll/pitch and z."""
    rpy = rpy.at[0].set(jnp.clip(rpy[0], -rotation_tolerance, rotation_tolerance))
    rpy = rpy.at[1].set(jnp.clip(rpy[1], -rotation_tolerance, rotation_tolerance))
    xyz = xyz.at[2].set(jnp.clip(xyz[2], -z_tolerance, z_tolerance))
    return rpy, xyz
