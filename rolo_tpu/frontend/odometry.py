"""Front-end scan-to-scan odometry: forward prediction + rotation
registration + continuous-time translation + pose integration.

JAX re-design of LidarOdometry
(/root/reference/src/lidarOdometry.cpp:325-713) as a pure
`scan_step(state, scan) -> (state, output)` function, lax.scan-compatible so
whole sequences run inside one jitted program and many sequences batch with
vmap.

Flow per scan (cloudHandler :503-570):
  1. stateLinearPropagation (:700-712): translation-only forward prediction,
     scaling the last inter-frame step by the interval ratio (rotation
     zeroed at :707).
  2. scanRegeistration (:448-501): polar rot-GICP rotation from identity on
     the translation-propagated features, then CT translation correction.
  3. updateTransform (:572-626): step transform T = [R | t], pose' =
     pose @ T^{-1} (right-multiply, :591).
  4. failureDetection (:629-643) — jump detection on the step (the
     reference computes it but has the call disabled at :596-599; here it is
     computed and returned as a flag, applied only if enabled).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import RegistrationConfig
from ..geometry import so3 as _so3
from ..geometry.se3 import SE3
from ..registration.rotgicp import register_features
from ..voxel.knn import estimate_cov6


class OdometryState(NamedTuple):
    """Carried state of the front-end (the members of LidarOdometry)."""

    pose_rot: jnp.ndarray  # [3,3] accumulated odometry pose (LaserOdomPose)
    pose_trans: jnp.ndarray  # [3]
    prev_xyz: jnp.ndarray  # [N,3] previous feature cloud (featureOld)
    prev_mask: jnp.ndarray  # [N]
    prev_cov: jnp.ndarray  # [6,N] sym3 planes
    step_rot: jnp.ndarray  # [3,3] last step transform (lidarMappingAffine)
    step_trans: jnp.ndarray  # [3]
    trans_old: jnp.ndarray  # [3] TranslationOld
    last_interval: jnp.ndarray  # [] lastMappingInterval
    initialized: jnp.ndarray  # [] bool: first frame seen


class OdometryOutput(NamedTuple):
    pose_rot: jnp.ndarray
    pose_trans: jnp.ndarray
    step_rot: jnp.ndarray
    step_trans: jnp.ndarray
    rot_error: jnp.ndarray
    converged: jnp.ndarray
    failure: jnp.ndarray  # jump-detection flag (informational by default)


def init_state(capacity: int, dtype=jnp.float32) -> OdometryState:
    return OdometryState(
        pose_rot=jnp.eye(3, dtype=dtype),
        pose_trans=jnp.zeros(3, dtype=dtype),
        prev_xyz=jnp.zeros((capacity, 3), dtype=dtype),
        prev_mask=jnp.zeros((capacity,), dtype=bool),
        prev_cov=jnp.broadcast_to(
            jnp.asarray([1.0, 0, 0, 1.0, 0, 1.0], dtype)[:, None], (6, capacity)
        ),
        step_rot=jnp.eye(3, dtype=dtype),
        step_trans=jnp.zeros(3, dtype=dtype),
        trans_old=jnp.zeros(3, dtype=dtype),
        last_interval=jnp.asarray(9999.0, dtype=dtype),
        initialized=jnp.asarray(False),
    )


def forward_predict(
    step_trans: jnp.ndarray, last_interval: jnp.ndarray, interval: jnp.ndarray
) -> jnp.ndarray:
    """stateLinearPropagation (lidarOdometry.cpp:700-712): scale the last
    step's translation by the interval ratio; rotation zeroed."""
    ratio = interval / jnp.maximum(last_interval, 1e-6)
    return step_trans * ratio


@partial(jax.jit, static_argnames=("cfg", "voxel_capacity", "k", "enable_failure_gate"))
def scan_step(
    state: OdometryState,
    new_xyz: jnp.ndarray,
    new_mask: jnp.ndarray,
    interval: jnp.ndarray,
    cfg: RegistrationConfig = RegistrationConfig(),
    voxel_capacity: int = 8192,
    k: int = 20,
    enable_failure_gate: bool = False,
) -> Tuple[OdometryState, OdometryOutput]:
    """One front-end odometry step. new_xyz/new_mask: this scan's feature
    cloud (corners + surfaces, lidarOdometry.cpp:524)."""
    dtype = new_xyz.dtype
    new_cov = estimate_cov6(new_xyz, new_mask, k=k, method=cfg.regularization)

    # --- registration against the previous scan ------------------------
    # forward prediction seeds the TOTAL step translation (:459 transforms
    # the cloud; register_features carries the total internally)
    guess = forward_predict(state.step_trans, state.last_interval, interval)
    res = register_features(
        state.prev_xyz, state.prev_mask, state.prev_cov,
        new_xyz, new_mask, new_cov,
        guess, state.trans_old, interval, state.last_interval,
        cfg, voxel_capacity,
    )
    step_rot = res.rot
    step_trans = res.trans  # total step: new ~ R prev + t (:500)

    # First frame: no registration, identity step (:526-533).
    first = ~state.initialized
    step_rot = jnp.where(first, jnp.eye(3, dtype=dtype), step_rot)
    step_trans = jnp.where(first, jnp.zeros(3, dtype=dtype), step_trans)

    # --- pose integration (updateTransform :572-626) --------------------
    step = SE3(step_rot, step_trans)
    step_inv = step.inverse()
    pose = SE3(state.pose_rot, state.pose_trans).compose(step_inv)

    # failureDetection (:629-643): velocity/rotation-rate bound on the step
    dt2 = jnp.maximum(interval, 1e-3) ** 2
    d_t = jnp.sum(step_inv.trans**2)
    d_r = jnp.sum(_so3.log(step_inv.rot) ** 2)
    failure = ((d_t / dt2 >= 5.0) | (d_r / dt2 >= 0.04)) & ~first
    if enable_failure_gate:
        # reset path (lidarOdometry.cpp:567-569 banner): hold the pose AND
        # zero the step, so the next forward prediction does not re-seed
        # from the rejected jump
        keep = failure
        pose = SE3(
            jnp.where(keep, state.pose_rot, pose.rot),
            jnp.where(keep, state.pose_trans, pose.trans),
        )
        step_rot = jnp.where(keep, jnp.eye(3, dtype=dtype), step_rot)
        step_trans = jnp.where(keep, jnp.zeros(3, dtype=dtype), step_trans)

    new_state = OdometryState(
        pose_rot=pose.rot,
        pose_trans=pose.trans,
        prev_xyz=new_xyz,
        prev_mask=new_mask,
        prev_cov=new_cov,
        step_rot=step_rot,
        step_trans=step_trans,
        trans_old=step_trans,
        last_interval=jnp.asarray(interval, dtype),
        initialized=jnp.asarray(True),
    )
    out = OdometryOutput(
        pose_rot=pose.rot,
        pose_trans=pose.trans,
        step_rot=step_rot,
        step_trans=step_trans,
        rot_error=res.rot_error,
        converged=res.converged,
        failure=failure,
    )
    return new_state, out


def run_sequence(
    feats_xyz: jnp.ndarray,
    feats_mask: jnp.ndarray,
    intervals: jnp.ndarray,
    cfg: RegistrationConfig = RegistrationConfig(),
    voxel_capacity: int = 8192,
    k: int = 20,
) -> OdometryOutput:
    """Run front-end odometry over a whole sequence inside one lax.scan.

    feats_xyz [T, N, 3], feats_mask [T, N], intervals [T]. Returns stacked
    per-scan outputs (poses form the trajectory)."""
    state = init_state(feats_xyz.shape[1], feats_xyz.dtype)

    def body(state, inp):
        xyz, mask, dt = inp
        state, out = scan_step(state, xyz, mask, dt, cfg, voxel_capacity, k)
        return state, out

    _, outs = jax.lax.scan(body, state, (feats_xyz, feats_mask, intervals))
    return outs
