"""Ground-prior observation pipeline: prior-pose computation, the prior
queue, and the keyframe association that emits prior between-factors.

JAX re-design of two reference pieces:
  - prior_pose_node::HandlePose (/root/reference/src/prior_pose/
    prior_pose_node.cpp:164-236): run the wheel-contact solver at a future
    (x, y, yaw), keep x/y/yaw, take z/roll/pitch from the solver, extract
    the ground patch around it,
  - backMapping::priorInfoHandler + performPriorAssociation
    (/root/reference/src/backMapping.cpp:459-513, 1943-2158): store the
    prior relative to its linked keyframe, and when the vehicle reaches the
    prior location, ICP the stored patch against the current ground cloud,
    gate on fitness and z/roll/pitch consistency, slerp-blend
    (priorWeight=0.2), and push an anisotropically-weighted between factor.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PriorConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..loop.closure import icp_point2point
from ..pointcloud.cloud import PaddedCloud
from .ground import GroundMap, extract_patch
from .vehicle import VehicleModel, solve_pose


class PriorObservation(NamedTuple):
    """One solved prior pose + its ground patch (the vehicle_prior_info
    payload, prior_pose_node.cpp:208-233)."""

    rot: jnp.ndarray  # [3,3] world-frame prior pose (x,y,yaw in; z,r,p solved)
    trans: jnp.ndarray  # [3]
    patch_xyz: jnp.ndarray  # [Gp, 3]
    patch_mask: jnp.ndarray  # [Gp]
    success: jnp.ndarray  # [] bool


@partial(jax.jit, static_argnames=("cfg", "patch_capacity"))
def compute_prior(
    gm: GroundMap,
    vehicle: VehicleModel,
    x: jnp.ndarray,
    y: jnp.ndarray,
    yaw: jnp.ndarray,
    cfg: PriorConfig = PriorConfig(),
    patch_capacity: int = 2048,
) -> PriorObservation:
    """HandlePose (prior_pose_node.cpp:164-236): solve (z, roll, pitch)
    given (x, y, yaw), build the full pose, extract the ground patch."""
    res = solve_pose(gm, vehicle, x, y, yaw, cfg)
    rot = so3.rpy_to_matrix(res.roll, res.pitch, yaw)
    trans = jnp.stack([jnp.asarray(x), jnp.asarray(y), res.z]).astype(gm.xyz.dtype)
    patch = extract_patch(gm, trans[:2], cfg.ground_patch_size, patch_capacity)
    return PriorObservation(
        rot=rot,
        trans=trans,
        patch_xyz=patch.xyz,
        patch_mask=patch.mask & res.success,
        success=res.success & patch.mask.any(),
    )


class PriorQueue(NamedTuple):
    """priorPosePatchHistory + priorTimeKeyQueue (backMapping.cpp:190-196):
    priors stored RELATIVE to their linked keyframe pose
    (priorInfoHandler :459-513)."""

    rel_rot: jnp.ndarray  # [P, 3, 3]
    rel_trans: jnp.ndarray  # [P, 3]
    linked_key: jnp.ndarray  # [P] int32
    patch_xyz: jnp.ndarray  # [P, Gp, 3]
    patch_mask: jnp.ndarray  # [P, Gp]
    valid: jnp.ndarray  # [P]
    count: jnp.ndarray  # [] int32
    last_time: jnp.ndarray  # [] stamp of the last accepted prior (rate limit)

    @property
    def capacity(self) -> int:
        return self.rel_rot.shape[0]


def init_queue(capacity: int, patch_capacity: int, dtype=jnp.float32) -> PriorQueue:
    return PriorQueue(
        rel_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (capacity, 3, 3)),
        rel_trans=jnp.zeros((capacity, 3), dtype),
        linked_key=jnp.zeros((capacity,), jnp.int32),
        patch_xyz=jnp.zeros((capacity, patch_capacity, 3), dtype),
        patch_mask=jnp.zeros((capacity, patch_capacity), bool),
        valid=jnp.zeros((capacity,), bool),
        count=jnp.asarray(0, jnp.int32),
        last_time=jnp.asarray(-jnp.inf, dtype),
    )


def push_prior(
    q: PriorQueue,
    obs: PriorObservation,
    linked_key: jnp.ndarray,
    linked_rot: jnp.ndarray,
    linked_trans: jnp.ndarray,
    enable: jnp.ndarray = True,
    obs_time: jnp.ndarray = None,
) -> PriorQueue:
    """priorInfoHandler (backMapping.cpp:459-513): store the prior relative
    to its linked keyframe's pose at observation time. Ring-buffer
    overwrite at capacity (the reference pops from the front)."""
    rel = SE3(linked_rot, linked_trans).inverse().compose(SE3(obs.rot, obs.trans))
    idx = q.count % q.capacity
    ok = jnp.asarray(enable) & obs.success
    if obs_time is None:
        obs_time = q.last_time

    def upd(arr, val):
        return jnp.where(ok, arr.at[idx].set(val), arr)

    return PriorQueue(
        rel_rot=upd(q.rel_rot, rel.rot),
        rel_trans=upd(q.rel_trans, rel.trans),
        linked_key=upd(q.linked_key, jnp.asarray(linked_key, jnp.int32)),
        patch_xyz=upd(q.patch_xyz, obs.patch_xyz),
        patch_mask=upd(q.patch_mask, obs.patch_mask),
        valid=upd(q.valid, True),
        count=jnp.where(ok, q.count + 1, q.count),
        last_time=jnp.where(ok, jnp.asarray(obs_time, q.last_time.dtype), q.last_time),
    )


def _slerp(qa: jnp.ndarray, qb: jnp.ndarray, t: float) -> jnp.ndarray:
    """Quaternion slerp (Eigen Quaternion::slerp semantics), (w,x,y,z)."""
    dot = jnp.sum(qa * qb)
    qb = jnp.where(dot < 0, -qb, qb)
    dot = jnp.abs(dot)
    dot = jnp.clip(dot, -1.0, 1.0)
    theta = jnp.arccos(dot)
    sin_theta = jnp.sin(theta)
    small = sin_theta < 1e-6
    wa = jnp.where(small, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.where(small, 1.0, sin_theta))
    wb = jnp.where(small, t, jnp.sin(t * theta) / jnp.where(small, 1.0, sin_theta))
    out = wa * qa + wb * qb
    return out / jnp.maximum(jnp.linalg.norm(out), 1e-12)


class PriorFactor(NamedTuple):
    i: jnp.ndarray  # linked keyframe
    j: jnp.ndarray  # current keyframe
    rel_rot: jnp.ndarray  # [3,3]
    rel_trans: jnp.ndarray  # [3]
    noise_var: jnp.ndarray  # [6] (rx, ry, rz, tx, ty, tz)
    accepted: jnp.ndarray  # bool


@partial(jax.jit, static_argnames=("cfg", "max_icp_iterations", "approx_knn"))
def associate_prior(
    q_entry_rel_rot: jnp.ndarray,
    q_entry_rel_trans: jnp.ndarray,
    q_entry_linked_key: jnp.ndarray,
    q_entry_patch: PaddedCloud,
    q_entry_valid: jnp.ndarray,
    linked_rot: jnp.ndarray,
    linked_trans: jnp.ndarray,
    current_key: jnp.ndarray,
    current_rot: jnp.ndarray,
    current_trans: jnp.ndarray,
    ground_now: PaddedCloud,
    cfg: PriorConfig = PriorConfig(),
    max_icp_iterations: int = 100,
    approx_knn: bool = False,
) -> PriorFactor:
    """performPriorAssociation inner match (backMapping.cpp:1981-2143) for
    one queue entry against the current keyframe:

      1. global prior = linked_pose o rel_prior; gate on xy distance to the
         current keyframe (< near_prior_radius),
      2. patch ICP against the current ground cloud, gated on fitness,
      3. z / roll / pitch consistency gates between the odometry relative
         motion and the prior relative motion,
      4. slerp blend (priorWeight = 0.2) of roll/pitch into the odometry
         rotation (translation kept from odometry, z-blend disabled in the
         reference :2072),
      5. between factor linked -> current with variances
         (s, s, 1e-6, 1e-6, 1e-6, s), s = max(fitness, 1e-6) * weight
         (:2132-2136, GTSAM tangent order rx, ry, rz, tx, ty, tz).
    """
    dtype = linked_trans.dtype
    linked = SE3(linked_rot, linked_trans)
    current = SE3(current_rot, current_trans)
    rel_prior = SE3(q_entry_rel_rot, q_entry_rel_trans)

    global_prior = linked.compose(rel_prior)
    dist = jnp.linalg.norm(global_prior.trans[:2] - current.trans[:2])
    near = dist < cfg.near_prior_radius

    icp = icp_point2point(
        q_entry_patch, ground_now, jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype),
        max_corr_dist=cfg.ground_patch_size, max_iterations=max_icp_iterations,
        approx_knn=approx_knn,
    )
    fit_ok = icp.converged & (icp.fitness < cfg.fitness_score)

    # Odometry vs corrected-prior relative motion, both expressed in the
    # LINKED keyframe's frame (right differences). Documented deviation:
    # the reference compares the LEFT difference `current * linked^-1`
    # against `icp * prior_world` (:2065-2066) — two quantities in
    # different frames whose z/roll/pitch only agree when the linked pose
    # sits near the origin with little accumulated yaw (the left-difference
    # z picks up ~|yaw_diff|*|linked_xy|, meters at 30 m from the start, so
    # the 1 m gate rejects every candidate on a curving trajectory). The
    # right-difference form compares the same physical quantity — the
    # relative pose linked -> {current, corrected prior} — and reduces to
    # the reference's form when linked ~ identity.
    odom_rel = linked.inverse().compose(current)
    icp_in_linked = linked.inverse().compose(SE3(icp.rot, icp.trans)).compose(linked)
    prior_rel = icp_in_linked.compose(rel_prior)

    o_roll, o_pitch, o_yaw = so3.matrix_to_rpy(odom_rel.rot)
    p_roll, p_pitch, _ = so3.matrix_to_rpy(prior_rel.rot)

    def angdiff(a, b):
        return jnp.abs(jnp.arctan2(jnp.sin(a - b), jnp.cos(a - b)))

    diff_ok = (
        (jnp.abs(odom_rel.trans[2] - prior_rel.trans[2]) <= cfg.trans_diff_tolerance)
        & (angdiff(o_roll, p_roll) <= cfg.rot_diff_tolerance_rad)
        & (angdiff(o_pitch, p_pitch) <= cfg.rot_diff_tolerance_rad)
    )

    # slerp-blend roll/pitch toward the prior, keep odometry yaw and
    # translation (z-blend disabled in the reference, :2072-2073); the
    # between factor IS the blended right difference linked -> current
    w = 0.2  # priorWeight (:2069)
    target_rot = so3.rpy_to_matrix(p_roll, p_pitch, o_yaw)
    blended_q = _slerp(
        so3.matrix_to_quat(odom_rel.rot), so3.matrix_to_quat(target_rot), w
    )
    rel = SE3(so3.quat_to_matrix(blended_q), odom_rel.trans)

    s = jnp.maximum(icp.fitness, 1e-6) * cfg.factor_weight
    noise = jnp.stack([s, s, jnp.asarray(1e-6, dtype), jnp.asarray(1e-6, dtype), jnp.asarray(1e-6, dtype), s])

    accepted = q_entry_valid & near & fit_ok & diff_ok & (q_entry_linked_key != current_key)
    return PriorFactor(
        i=jnp.asarray(q_entry_linked_key, jnp.int32),
        j=jnp.asarray(current_key, jnp.int32),
        rel_rot=rel.rot,
        rel_trans=rel.trans,
        noise_var=noise,
        accepted=accepted,
    )
