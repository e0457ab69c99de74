"""Vehicle ground-contact pose solver: LM over (z, roll, pitch) at fixed
(x, y, yaw).

JAX re-design of ground_factor::VehicleModel / PoseSolver
(/root/reference/src/prior_pose/pose_solver.cpp:54-118, 379-679): spring
contact forces on wheels below the ground surface, a gravity-alignment
wrench residual, the analytic 3x3 Jacobian (ComputeResidualAndJacobian
:597-679), fixed-yaw rotation re-projection (EnforceFixedYaw :584-589),
initial z from the minimum wheel ground height (InitialZ :558-578), and
solution gating (FailureDetection :536-556).

The per-wheel kd-tree ground queries become masked reductions over the
GroundMap (see ground.py); with W wheels and the 3-dim state this is tiny
per instance but batches over thousands of (x, y, yaw) queries with vmap —
the pod-scale prior workload.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PriorConfig
from ..geometry import so3
from .ground import GroundMap, average_height_at, contact_point, nearest_point_xy


class VehicleModel(NamedTuple):
    """Wheel-contact geometry (VehicleModel, pose_solver.cpp:54-118)."""

    wheel_points_body: jnp.ndarray  # [W, 3] = (x, y, -com_z)
    com_z: jnp.ndarray  # []
    lidar_offset_rot: jnp.ndarray  # [3, 3] body->lidar
    lidar_offset_trans: jnp.ndarray  # [3]


def from_config(cfg: PriorConfig, dtype=jnp.float32) -> VehicleModel:
    """Build from PriorConfig: explicit wheel_xy list, or FromSquare
    (pose_solver.cpp:71-81) when none given."""
    if cfg.wheel_xy:
        xy = jnp.asarray(cfg.wheel_xy, dtype)
    else:
        half = cfg.vehicle_size_xy / 2.0
        xy = jnp.asarray(
            [[-half, half], [half, half], [half, -half], [-half, -half]], dtype
        )
    wheels = jnp.concatenate(
        [xy, jnp.full((xy.shape[0], 1), -cfg.vehicle_com_z, dtype)], axis=-1
    )
    return VehicleModel(
        wheel_points_body=wheels,
        com_z=jnp.asarray(cfg.vehicle_com_z, dtype),
        lidar_offset_rot=jnp.eye(3, dtype=dtype),
        lidar_offset_trans=jnp.asarray(cfg.lidar_offset_trans, dtype),
    )


def _rot_z(yaw):
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [jnp.stack([c, -s, z]), jnp.stack([s, c, z]), jnp.stack([z, z, o])]
    )


def _enforce_fixed_yaw(r: jnp.ndarray, yaw_fixed) -> jnp.ndarray:
    """EnforceFixedYaw (pose_solver.cpp:584-589): strip the current yaw and
    re-apply the fixed one."""
    yaw_cur = jnp.arctan2(r[1, 0], r[0, 0])
    return _rot_z(yaw_fixed) @ _rot_z(-yaw_cur) @ r


def _roll_pitch_from_fixed_yaw(r: jnp.ndarray, yaw_fixed):
    """ComputeRollPitchFromFixedYaw (pose_solver.cpp:591-595)."""
    r_tilt = _rot_z(-yaw_fixed) @ r
    roll = jnp.arctan2(r_tilt[2, 1], r_tilt[2, 2])
    pitch = jnp.arctan2(-r_tilt[2, 0], r_tilt[0, 0])
    return roll, pitch


def _residual_and_jacobian(gm: GroundMap, wheels_b, x, y, yaw, z, r, k_spring, g):
    """ComputeResidualAndJacobian (pose_solver.cpp:597-679).

    residual [3] = wrench_map @ contact_forces + g * (n_w . ez, 0, 0);
    jacobian [3, 3] columns = d/d(z, roll, pitch).
    """
    dtype = r.dtype
    ez = jnp.array([0.0, 0.0, 1.0], dtype)
    sx = so3.skew(jnp.array([1.0, 0.0, 0.0], dtype))
    sy = so3.skew(jnp.array([0.0, 1.0, 0.0], dtype))

    t = jnp.array([x, y, z], dtype)
    n_w = r @ ez  # vehicle normal in world

    # wrench map rows: (1, r_y, -r_x) per wheel (:623-628)
    wmap = jnp.stack(
        [jnp.ones(wheels_b.shape[0], dtype), wheels_b[:, 1], -wheels_b[:, 0]]
    )  # [3, W]

    def per_wheel(p_b):
        pw = r @ p_b + t
        p_n = contact_point(gm, pw[:2])
        a = pw - p_n
        d_i = jnp.dot(a, n_w)
        active = d_i < 0.0
        f_i = jnp.where(active, k_spring * d_i, 0.0)
        rp = r @ p_b
        dd_dz = n_w[2]
        dd_droll = jnp.dot(sx @ rp, n_w) + jnp.dot(a, sx @ n_w)
        dd_dpitch = jnp.dot(sy @ rp, n_w) + jnp.dot(a, sy @ n_w)
        act = active.astype(dtype) * k_spring
        return f_i, act * dd_dz, act * dd_droll, act * dd_dpitch

    f, dfz, dfr, dfp = jax.vmap(per_wheel)(wheels_b)

    residual = wmap @ f + g * jnp.array([n_w[2], 0.0, 0.0], dtype)
    jac = jnp.stack([wmap @ dfz, wmap @ dfr, wmap @ dfp], axis=-1)
    jac = jac.at[0, 1].add(g * jnp.dot(ez, sx @ n_w))
    jac = jac.at[0, 2].add(g * jnp.dot(ez, sy @ n_w))
    return residual, jac


class SolverResult(NamedTuple):
    """SolverResult (pose_solver.hpp + Solve, pose_solver.cpp:391-534)."""

    z: jnp.ndarray
    roll: jnp.ndarray
    pitch: jnp.ndarray
    rot: jnp.ndarray  # [3, 3] best rotation (fixed yaw)
    cost: jnp.ndarray
    wheel_signed_distances: jnp.ndarray  # [W]
    converged: jnp.ndarray  # end_reason == "converged"
    success: jnp.ndarray  # FailureDetection verdict


def _initial_z(gm: GroundMap, wheels_b, x, y, yaw, com_z, radius, min_neighbors):
    """InitialZ (pose_solver.cpp:558-578): min averaged wheel ground height
    + com_z - 1.0; zero when no wheel query succeeds."""
    rz = _rot_z(yaw)

    def one(p_b):
        w_xy = (rz @ p_b)[:2] + jnp.array([x, y], p_b.dtype)
        h, ok = average_height_at(gm, w_xy, radius, min_neighbors)
        return jnp.where(ok, h, jnp.inf)

    hs = jax.vmap(one)(wheels_b)
    min_h = jnp.min(hs)
    return jnp.where(jnp.isfinite(min_h), min_h + com_z - 1.0, 0.0)


@partial(jax.jit, static_argnames=("cfg",))
def solve_pose(
    gm: GroundMap,
    vehicle: VehicleModel,
    x: jnp.ndarray,
    y: jnp.ndarray,
    yaw: jnp.ndarray,
    cfg: PriorConfig = PriorConfig(),
) -> SolverResult:
    """PoseSolver::Solve (pose_solver.cpp:391-534): LM over (z, roll,
    pitch) with accept/reject steps and the adaptive lambda schedule
    (/2 on accept, x5 on reject), tracking the best-cost iterate."""
    dtype = vehicle.wheel_points_body.dtype
    wheels = vehicle.wheel_points_body
    x = jnp.asarray(x, dtype)
    y = jnp.asarray(y, dtype)
    yaw = jnp.asarray(yaw, dtype)
    k_spring = jnp.asarray(cfg.k_spring, dtype)
    g = jnp.asarray(cfg.gravity, dtype)

    r0 = _rot_z(yaw)
    z0 = _initial_z(
        gm, wheels, x, y, yaw, vehicle.com_z, cfg.ground_avg_radius, cfg.ground_min_neighbors
    )

    def body(state):
        z, r, lam, last_cost, best_cost, best_z, best_r, it, conv = state
        res, jac = _residual_and_jacobian(gm, wheels, x, y, yaw, z, r, k_spring, g)
        c0 = jnp.dot(res, res)
        better = c0 < best_cost
        best_cost = jnp.where(better, c0, best_cost)
        best_z = jnp.where(better, z, best_z)
        best_r = jnp.where(better, r, best_r)

        a = jac.T @ jac + lam * jnp.eye(3, dtype=dtype)
        b = -(jac.T @ res)
        delta = jnp.linalg.solve(a, b)
        solvable = jnp.all(jnp.isfinite(delta))
        delta = jnp.where(solvable, delta, 0.0)

        z_new = z + delta[0]
        r_new = so3.exp(jnp.array([1.0, 0.0, 0.0], dtype) * delta[1]) @ (
            so3.exp(jnp.array([0.0, 1.0, 0.0], dtype) * delta[2]) @ r
        )
        r_new = _enforce_fixed_yaw(r_new, yaw)
        res_new, _ = _residual_and_jacobian(gm, wheels, x, y, yaw, z_new, r_new, k_spring, g)
        c1 = jnp.dot(res_new, res_new)

        accept = solvable & (c1 < c0)
        step_norm = jnp.linalg.norm(delta)
        # Converged on an accepted plateau (the reference test,
        # pose_solver.cpp:469-473) OR at stationarity: a tiny LM proposal
        # step means the solver has nothing left to move, regardless of the
        # cost delta. The cost-delta test alone is unusable in f32 — the
        # cost floor jitters at ~5e-8 (measured: the solver reaches 2e-8 by
        # iteration 3, then reject-loops to max_iters because |c1-c0| stays
        # above tol_cost), which silently failed ~45% of prior-solver ticks
        # through round 3. Solution-quality gating is FailureDetection's
        # job (roll/pitch/wheel-distance bounds below), not convergence's.
        conv_now = (
            accept & (jnp.abs(last_cost - c1) < cfg.tol_cost)
        ) | (solvable & (step_norm < cfg.tol_step))

        z = jnp.where(accept, z_new, z)
        r = jnp.where(accept, r_new, r)
        lam = jnp.where(
            ~solvable, lam * 10.0, jnp.where(accept, jnp.maximum(lam / 2.0, 1e-8), lam * 5.0)
        )
        last_cost = jnp.where(accept, c1, c0)
        return (z, r, lam, last_cost, best_cost, best_z, best_r, it + 1, conv | conv_now)

    def cond(state):
        *_, it, conv = state
        return (it < cfg.max_iters) & ~conv

    init = (
        z0, r0, jnp.asarray(cfg.lm_lambda, dtype), jnp.asarray(jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype), z0, r0, jnp.asarray(0, jnp.int32), jnp.array(False),
    )
    _, _, _, _, best_cost, best_z, best_r, _, conv = jax.lax.while_loop(cond, body, init)

    roll, pitch = _roll_pitch_from_fixed_yaw(best_r, yaw)

    # wheel signed distances at the solution (:488-500)
    t = jnp.array([x, y, best_z], dtype)
    n_w = best_r @ jnp.array([0.0, 0.0, 1.0], dtype)

    def signed_dist(p_b):
        pw = best_r @ p_b + t
        p_n = nearest_point_xy(gm, pw[:2])
        return jnp.dot(pw - p_n, n_w)

    dists = jax.vmap(signed_dist)(wheels)

    # FailureDetection (:536-556)
    success = (
        conv
        & (best_z >= cfg.tolerance_z_min)
        & (best_z <= cfg.tolerance_z_max)
        & (jnp.abs(roll) <= cfg.tolerance_roll)
        & (jnp.abs(pitch) <= cfg.tolerance_pitch)
        & jnp.all(jnp.abs(dists) <= cfg.tolerance_wheel_distance)
        & gm.ready
    )
    return SolverResult(
        z=best_z, roll=roll, pitch=pitch, rot=best_r, cost=best_cost,
        wheel_signed_distances=dists, converged=conv, success=success,
    )
