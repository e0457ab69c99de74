"""Point-axis SPMD registration: one large scan pair sharded over a mesh.

parallel/batch.py scales by *batch* (many independent scan pairs — data
parallelism). This module scales the *inside* of a single registration: the
source cloud's point axis is split across devices with `shard_map`, every
device linearizes its shard of correspondences, and the tiny dense results —
the 3x3 / 6x6 Hessians, gradients, and scalar errors of the LM solvers —
are reduced with `jax.lax.psum` across the devices. This is the
"Hessian-block reduction" collective promised in SURVEY.md section 2.7: the
mesh equivalent of the reference's per-thread OpenMP accumulators reduced
serially (rot_vgicp_impl.hpp:242-287, :313-382, :522-600).

Because the psummed (error, H, b) are bitwise identical on every device,
the LM while-loops (registration/lm.py) run in lockstep across the mesh
with no divergence — the same driver code runs sharded or local, only the
reduction hooks differ.

Cost model (D devices, N source points, V voxels, S stat planes):
  - correspondence join per LM iteration: S * V * N/D   -> scales 1/D
  - source covariances (moment kNN): N/D queries vs the all-gathered
    cloud                                               -> scales 1/D
  - target covariances: sliced 1/D, cov6 planes all-gathered
  - voxel-map build: replicated (one keyed matmul, ~1% of a solve)
  - per-iteration collective: psum of 3x3/6x6 + scalars  -> O(1)

Use this path when a single cloud is too big for one chip's 10 Hz budget
(dense scans, submap-to-submap alignment); use parallel/batch.py when there
are many pairs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.6 exposes shard_map at top level
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..config import RegistrationConfig
from ..ops import sym3
from ..registration import gicp, lm
from ..registration.rotgicp import ScanPairResult
from ..voxel.knn import estimate_cov6
from ..voxel.voxelmap import build_voxel_map


def _psum_reducers(axis_name: str):
    """Objective reductions with cross-device psums for the LM drivers."""

    def so3_linearize(ctx, corr, rot, trans):
        return jax.lax.psum(gicp.so3_linearize(ctx, corr, rot, trans), axis_name)

    def compute_error(ctx, corr, rot, trans):
        return jax.lax.psum(gicp.compute_error(ctx, corr, rot, trans), axis_name)

    def ct_linearize(ctx, corr, t, g, last, dtn, dtn1, ct_lambda):
        n_glob = jnp.maximum(
            jax.lax.psum(jnp.sum(corr.weight > 0), axis_name), 1.0
        )
        out = gicp.ct_linearize(
            ctx, corr, t, g, last, dtn, dtn1, ct_lambda, n_corr_override=n_glob
        )
        return jax.lax.psum(out, axis_name)

    def ct_error(ctx, corr, t, g, last, dtn, dtn1, ct_lambda):
        n_glob = jnp.maximum(
            jax.lax.psum(jnp.sum(corr.weight > 0), axis_name), 1.0
        )
        return jax.lax.psum(
            gicp.ct_error(
                ctx, corr, t, g, last, dtn, dtn1, ct_lambda, n_corr_override=n_glob
            ),
            axis_name,
        )

    return so3_linearize, compute_error, ct_linearize, ct_error


def register_scan_pair_spmd(
    mesh: Mesh,
    src_xyz: jnp.ndarray,
    src_mask: jnp.ndarray,
    tgt_xyz: jnp.ndarray,
    tgt_mask: jnp.ndarray,
    init_translation: jnp.ndarray,
    last_translation: jnp.ndarray,
    interval_tn: jnp.ndarray,
    interval_tn_1: jnp.ndarray,
    cfg: RegistrationConfig = RegistrationConfig(),
    voxel_capacity: int = 8192,
    k: int = 20,
    axis_name: str = "point",
) -> ScanPairResult:
    """One rot-GICP scan-pair registration with the point axis sharded.

    Same contract as registration.rotgicp.register_scan_pair (raw source
    features + `init_translation` = forward-predicted step; returns the
    TOTAL step transform) and the same alternating rotation/translation +
    fine-stage flow (rotgicp.register_features); the source/target point
    counts must be divisible by the mesh axis size. Results are replicated
    across devices and numerically match the single-device path up to
    reduction reassociation (psum order).
    """
    n_src = src_xyz.shape[0]
    n_tgt = tgt_xyz.shape[0]
    d = mesh.shape[axis_name]
    if n_src % d or n_tgt % d:
        raise ValueError(f"point counts ({n_src}, {n_tgt}) must divide mesh axis {d}")
    so3_lin, err_fn, ct_lin, ct_err = _psum_reducers(axis_name)
    polar_res_np = cfg.polar_resolution if cfg.voxel_type == "polar" else None

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(axis_name), P(axis_name),  # src sharded
            P(), P(),                    # tgt replicated (map build needs all)
            P(), P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    def run(src, smask, tgt, tmask, init_t, last_t, dtn, dtn1):
        dtype = src.dtype
        init_t = init_t.reshape(3)
        last_t = last_t.reshape(3)
        dtn = dtn.reshape(())
        dtn1 = dtn1.reshape(())

        # source covariances: local queries vs. the all-gathered full cloud
        full_src = jax.lax.all_gather(src, axis_name, tiled=True)
        full_smask = jax.lax.all_gather(smask, axis_name, tiled=True)
        src_cov = estimate_cov6(
            src, smask, k=k, method=cfg.regularization,
            cand_xyz=full_src, cand_mask=full_smask,
        )

        # target covariances: compute 1/D slice, all-gather the planes
        i = jax.lax.axis_index(axis_name)
        nt_loc = n_tgt // d
        tgt_loc = jax.lax.dynamic_slice_in_dim(tgt, i * nt_loc, nt_loc)
        tmask_loc = jax.lax.dynamic_slice_in_dim(tmask, i * nt_loc, nt_loc)
        tcov_loc = estimate_cov6(
            tgt_loc, tmask_loc, k=k, method=cfg.regularization,
            cand_xyz=tgt, cand_mask=tmask,
        )
        tgt_cov = jax.lax.all_gather(tcov_loc, axis_name, axis=1, tiled=True)

        polar_res = (
            jnp.asarray(polar_res_np, dtype) if polar_res_np is not None else None
        )
        vmap = build_voxel_map(
            tgt, tgt_cov, tmask, voxel_capacity,
            polar_res=polar_res, resolution=cfg.voxel_resolution,
        )
        # alternating rotation/translation (rotgicp.register_features) with
        # local-shard contexts; the psum'd reducers make each linearization
        # globally exact
        eye = jnp.eye(3, dtype=dtype)
        multi = cfg.alt_rounds > 1 or cfg.ct_fine_resolution > 0
        ct_outer = min(cfg.max_outer_iterations, 16) if multi else cfg.max_outer_iterations
        ct_rebinds = min(cfg.ct_rebind_rounds, 2) if multi else cfg.ct_rebind_rounds

        def one_round(rot, t):
            ctx_r = gicp.make_context(
                src + (rot.T @ t)[None, :], smask, src_cov, vmap,
                polar_res=polar_res, resolution=cfg.voxel_resolution,
                neighbor_search=cfg.neighbor_search,
            )
            rot_res = lm.lm_register_rotation(
                ctx_r, rot, jnp.zeros(3, dtype=dtype),
                max_outer=cfg.max_outer_iterations,
                max_inner=cfg.lm_max_inner_iterations,
                rot_eps=cfg.rotation_epsilon,
                trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor,
                linearize_fn=so3_lin, error_fn=err_fn,
            )
            rot = rot_res.rot
            ctx_t = gicp.make_context(
                src @ rot.T, smask, sym3.congruence(rot, src_cov), vmap,
                polar_res=polar_res, resolution=cfg.voxel_resolution,
                neighbor_search=cfg.neighbor_search,
            )
            ct_res = lm.lm_translation_rebind(
                ctx_t, eye, t,
                jnp.zeros(3, dtype=dtype), last_t, dtn, dtn1, cfg.ct_lambda,
                rebind_rounds=ct_rebinds,
                max_outer=ct_outer,
                max_inner=cfg.lm_max_inner_iterations,
                trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor,
                ct_linearize_fn=ct_lin, ct_error_fn=ct_err,
            )
            return rot, ct_res.trans, rot_res, ct_res

        rot, t, rot_res, ct_res = one_round(eye, init_t)
        prev_t = init_t
        for _ in range(max(int(cfg.alt_rounds), 1) - 1):
            # same cold-start gate as rotgicp.register_features
            moved = jnp.linalg.norm(t - prev_t)
            need = moved > jnp.maximum(0.15, 0.25 * jnp.linalg.norm(t))
            prev_t = t
            rot, t, rot_res, ct_res = jax.lax.cond(
                need,
                lambda r, tt: one_round(r, tt),
                lambda r, tt: (r, tt, rot_res, ct_res),
                rot, t,
            )

        if cfg.ct_fine_resolution > 0:
            vmap_f = build_voxel_map(
                tgt, tgt_cov, tmask, voxel_capacity,
                polar_res=None, resolution=cfg.ct_fine_resolution,
            )
            ctx_f = gicp.make_context(
                src @ rot.T, smask, sym3.congruence(rot, src_cov), vmap_f,
                polar_res=None, resolution=cfg.ct_fine_resolution,
                neighbor_search=cfg.ct_fine_neighbors,
            )
            ct_res = lm.lm_translation_rebind(
                ctx_f, eye, t,
                jnp.zeros(3, dtype=dtype), last_t, dtn, dtn1, cfg.ct_lambda,
                rebind_rounds=ct_rebinds,
                max_outer=ct_outer,
                max_inner=cfg.lm_max_inner_iterations,
                trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor,
                ct_linearize_fn=ct_lin, ct_error_fn=ct_err,
            )
            t = ct_res.trans

        return ScanPairResult(
            rot=rot,
            trans=t,
            rot_error=rot_res.error,
            ct_error=ct_res.error,
            rot_iterations=rot_res.iterations,
            ct_iterations=ct_res.iterations,
            converged=rot_res.converged & ct_res.converged,
        )

    return run(
        src_xyz, src_mask, tgt_xyz, tgt_mask,
        jnp.asarray(init_translation), jnp.asarray(last_translation),
        jnp.asarray(interval_tn, src_xyz.dtype).reshape(1),
        jnp.asarray(interval_tn_1, src_xyz.dtype).reshape(1),
    )
