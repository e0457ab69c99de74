"""Loop-closure candidate search, submap assembly, and ICP verification.

JAX re-design of backMapping's loop-closure thread
(/root/reference/src/backMapping.cpp:1904-1927, 2307-2624):

  - detectLoopClosureDistance (:2481-2515): nearest keyframe within the
    history search radius whose timestamp differs by more than
    `history_search_time_diff` — a masked argmin instead of a kd-tree
    radius search,
  - loopFindNearKeyframes (:2572-2596): submap assembly of +-search_num
    keyframes transformed to world by their own poses (the reference's
    `...WithRespectTo` SC variant transforms everything by a common base
    pose, which only conjugates the relative ICP estimate; the world-frame
    assembly used here is the drift-equivalent standard form),
  - ICP verification (:2430-2443): masked point-to-point ICP with
    SVD/Kabsch re-estimation per iteration (pcl::IterativeClosestPoint
    analog — correspondence search is a chunked distance matrix),
  - factor construction (:2368-2393): rel = poseFrom^{-1} poseTo with
    poseFrom = correction * T_cur, poseTo = T_prev, isotropic variance =
    ICP fitness; SC loops additionally get a Cauchy(1.0) robust kernel
    (:2464-2476).
"""

from __future__ import annotations

from functools import partial
from typing import TYPE_CHECKING, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.se3 import SE3
from ..pointcloud.cloud import PaddedCloud

if TYPE_CHECKING:  # annotation-only: avoids a loop<->mapping import cycle
    from ..mapping.keyframes import KeyframeDB
from ..pointcloud.features import voxel_downsample
from ..voxel.knn import knn_indices


def detect_loop_distance(
    db: KeyframeDB,
    already_matched: jnp.ndarray,
    search_radius: float,
    time_diff: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """detectLoopClosureDistance (backMapping.cpp:2481-2515): for the latest
    keyframe, the nearest older keyframe within `search_radius` whose time
    differs by more than `time_diff`. `already_matched` [K] suppresses
    keyframes that already own a loop factor (loopIndexContainer check).

    Returns (prev_index, found)."""
    cur = jnp.maximum(db.count - 1, 0)
    cur_trans = db.trans[cur]
    cur_time = db.time[cur]
    valid = db.valid()
    d2 = jnp.sum((db.trans - cur_trans) ** 2, axis=-1)
    ok = (
        valid
        & (d2 <= search_radius**2)
        & (jnp.abs(db.time - cur_time) > time_diff)
        & (jnp.arange(db.capacity) != cur)
    )
    score = jnp.where(ok, d2, jnp.inf)
    prev = jnp.argmin(score)
    found = jnp.isfinite(score[prev]) & ~already_matched[cur] & (db.count > 0)
    return prev.astype(jnp.int32), found


def assemble_loop_submap(
    db: KeyframeDB,
    key: jnp.ndarray,
    search_num: int,
    out_capacity: int,
    leaf: float,
) -> PaddedCloud:
    """loopFindNearKeyframes (backMapping.cpp:2572-2596): corner+surf clouds
    of keyframes [key-search_num, key+search_num], each transformed to world
    by its own pose, then voxel-downsampled to `out_capacity`."""
    offsets = jnp.arange(-search_num, search_num + 1)
    idx = key + offsets
    in_range = (idx >= 0) & (idx < db.count)
    idx = jnp.clip(idx, 0, db.capacity - 1)

    rot = db.rot[idx]
    trans = db.trans[idx]

    def to_world(xyz, mask):
        world = jnp.einsum("mij,mnj->mni", rot, xyz[idx]) + trans[:, None, :]
        return world.reshape(-1, 3), (mask[idx] & in_range[:, None]).reshape(-1)

    cx, cm = to_world(db.corner_xyz, db.corner_mask)
    sx, sm = to_world(db.surf_xyz, db.surf_mask)
    flat = PaddedCloud(jnp.concatenate([cx, sx]), jnp.concatenate([cm, sm]))
    return voxel_downsample(flat, leaf, out_capacity)


class ICPResult(NamedTuple):
    rot: jnp.ndarray  # [3, 3]
    trans: jnp.ndarray  # [3]
    fitness: jnp.ndarray  # mean squared correspondence distance
    converged: jnp.ndarray  # bool


@partial(jax.jit, static_argnames=("max_iterations", "chunk", "approx_knn"))
def icp_point2point(
    src: PaddedCloud,
    tgt: PaddedCloud,
    init_rot: jnp.ndarray,
    init_trans: jnp.ndarray,
    max_corr_dist: float,
    max_iterations: int = 100,
    # termination-only (the converged flag is correspondence-based, pcl
    # semantics). The reference's setTransformationEpsilon(1e-6) is an
    # f64 "pose stopped moving" test; in f32 the per-iteration Kabsch
    # re-estimate jitters by ~|x|*eps and the round-5 measurement on a
    # real loop pair showed 1e-5 is NEVER met (100/100 iterations burned,
    # |delta| stalling in the 1e-5..1e-4 band). 1e-4 (0.1 mm / 0.1 mrad)
    # is the f32 equivalent of "stopped moving" at lidar coordinate
    # scale: measured exit at 14 iterations with the same fitness to 4
    # significant digits (0.12195 vs 0.12197) instead of burning all 100.
    transformation_epsilon: float = 1e-4,
    chunk: int = 512,
    approx_knn: bool = False,
) -> ICPResult:
    """Masked point-to-point ICP (pcl::IterativeClosestPoint analog,
    backMapping.cpp:2430-2443): nearest-neighbor correspondences gated by
    `max_corr_dist`, closed-form SVD/Kabsch pose re-estimation per
    iteration. Fitness = mean squared nearest-neighbor distance of valid
    source points under the final transform (pcl getFitnessScore)."""
    dtype = src.xyz.dtype
    eye = jnp.eye(3, dtype=dtype)

    def correspondences(rot, trans):
        moved = jnp.einsum("ij,nj->ni", rot, src.xyz) + trans
        idx = knn_indices(moved, src.mask, tgt.xyz, tgt.mask, 1, chunk, approximate=approx_knn)[:, 0]
        nn = tgt.xyz[idx]
        d2 = jnp.sum((moved - nn) ** 2, axis=-1)
        w = (src.mask & (d2 < max_corr_dist**2)).astype(dtype)
        return moved, nn, d2, w

    def body(state):
        rot, trans, _, it, conv = state
        moved, nn, d2, w = correspondences(rot, trans)
        wsum = jnp.maximum(jnp.sum(w), 1e-6)
        # Kabsch on the ORIGINAL source points -> absolute (R, t) per
        # iteration, like pcl's SVD transform estimation.
        cs = jnp.einsum("n,ni->i", w, src.xyz) / wsum
        ct = jnp.einsum("n,ni->i", w, nn) / wsum
        h = jnp.einsum("n,ni,nj->ij", w, src.xyz - cs, nn - ct)
        u, _, vt = jnp.linalg.svd(h)
        d = jnp.linalg.det(vt.T @ u.T)
        s = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype)).at[2, 2].set(d)
        new_rot = vt.T @ s @ u.T
        new_trans = ct - new_rot @ cs
        delta = jnp.max(
            jnp.abs(
                SE3(rot, trans).inverse().compose(SE3(new_rot, new_trans)).as_matrix()
                - jnp.eye(4, dtype=dtype)
            )
        )
        conv = delta < transformation_epsilon
        err = jnp.sum(w * d2) / wsum
        return (new_rot, new_trans, err, it + 1, conv)

    def cond(state):
        _, _, _, it, conv = state
        return (it < max_iterations) & ~conv

    state = (init_rot, init_trans, jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32), jnp.array(False))
    rot, trans, _, it, conv = jax.lax.while_loop(cond, body, state)

    # final fitness over ALL valid source points (pcl getFitnessScore has no
    # distance gate by default)
    moved = jnp.einsum("ij,nj->ni", rot, src.xyz) + trans
    idx = knn_indices(moved, src.mask, tgt.xyz, tgt.mask, 1, chunk, approximate=approx_knn)[:, 0]
    d2 = jnp.sum((moved - tgt.xyz[idx]) ** 2, axis=-1)
    wm = src.mask.astype(dtype)
    fitness = jnp.sum(wm * d2) / jnp.maximum(jnp.sum(wm), 1e-6)
    # pcl hasConverged() semantics: align() "converges" whenever it
    # terminates with a usable correspondence set — the epsilon test OR the
    # iteration budget both count (DefaultConvergenceCriteria
    # CONVERGENCE_CRITERIA_ITERATIONS); it is false only for degenerate runs
    # with too few gated correspondences. The f32 epsilon test alone sits at
    # its floor (~|x|·eps per Kabsch re-estimate, ~3e-6 at 30 m coordinates)
    # without ever meeting 1e-6, so gating on it would reject perfect
    # alignments — this silently zeroed ALL prior factors through round 3
    # (associate_prior gates on `converged`, backMapping.cpp:2446 analog).
    n_corr = jnp.sum(src.mask & tgt.mask[idx] & (d2 < max_corr_dist**2))
    converged = n_corr >= 3
    return ICPResult(rot, trans, fitness, converged)


class LoopFactor(NamedTuple):
    """One verified loop constraint ready for graph insertion."""

    i: jnp.ndarray  # cur keyframe index
    j: jnp.ndarray  # prev keyframe index
    rel_rot: jnp.ndarray  # [3,3] measured T_i^{-1} T_j
    rel_trans: jnp.ndarray  # [3]
    noise_var: jnp.ndarray  # [6]
    robust_c: jnp.ndarray  # [] Cauchy k (0 = gaussian)
    accepted: jnp.ndarray  # bool


def verify_loop(
    db: KeyframeDB,
    cur_key: jnp.ndarray,
    prev_key: jnp.ndarray,
    cur_submap: PaddedCloud,
    prev_submap: PaddedCloud,
    init_yaw: jnp.ndarray,
    max_corr_dist: float,
    fitness_threshold: float,
    robust: bool,
    max_iterations: int = 100,
    approx_knn: bool = False,
) -> LoopFactor:
    """ICP-verify a loop candidate and build its between factor
    (performSC/RSLoopClosure, backMapping.cpp:2354-2393, 2455-2476).

    `init_yaw` seeds the ICP with the scan-context yaw estimate (0 for RS
    loops; the reference computes this guess at :2436 but aligns from
    identity — seeding is strictly better and costs nothing here)."""
    dtype = db.trans.dtype
    c, s = jnp.cos(init_yaw), jnp.sin(init_yaw)
    init_rot = jnp.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype)

    icp = icp_point2point(
        cur_submap, prev_submap, init_rot, jnp.zeros(3, dtype),
        max_corr_dist=max_corr_dist, max_iterations=max_iterations,
        approx_knn=approx_knn,
    )

    t_cur = SE3(db.rot[cur_key], db.trans[cur_key])
    t_prev = SE3(db.rot[prev_key], db.trans[prev_key])
    pose_from = SE3(icp.rot, icp.trans).compose(t_cur)  # corrected cur pose
    rel = pose_from.inverse().compose(t_prev)  # poseFrom.between(poseTo)

    # pcl's hasConverged() is also true when the iteration budget runs out
    # (DefaultConvergenceCriteria CONVERGENCE_CRITERIA_ITERATIONS), so the
    # reference's `hasConverged() == false` reject (backMapping.cpp:2446)
    # only fires on degenerate runs — gate on the fitness score, not on the
    # epsilon test (f32 ICP can oscillate at its floor without meeting 1e-6).
    accepted = (
        jnp.isfinite(icp.fitness)
        & (icp.fitness < fitness_threshold)
        & (cur_key != prev_key)
    )
    noise = jnp.full((6,), jnp.maximum(icp.fitness, 1e-6), dtype)
    return LoopFactor(
        i=cur_key.astype(jnp.int32),
        j=prev_key.astype(jnp.int32),
        rel_rot=rel.rot,
        rel_trans=rel.trans,
        noise_var=noise,
        robust_c=jnp.asarray(1.0 if robust else 0.0, dtype),
        accepted=accepted,
    )
