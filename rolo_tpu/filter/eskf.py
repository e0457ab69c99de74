"""Manifold pose error-state Kalman filter (ESKF), in JAX.

Re-design of the reference's PoseESEKF
(/root/reference/include/rolo/eskf/eskf.hpp) and the parts of the vendored
IKFoM toolkit it instantiates
(/root/reference/include/rolo/eskf/IKFoM_toolkit/esekfom/esekfom.hpp:275-700):
a constant-jerk 18-DoF filter on (pos, SO3 rot, vel, omega, acc, alpha)
with iterated pose-measurement updates.

Instead of the C++ template machinery (MTK manifolds + macro-generated
boxplus), state is a NamedTuple pytree with an explicit [18,18] covariance;
predict and update are pure functions, jit/vmap-friendly, so thousands of
filters (one per concurrent sequence) batch on one chip.

Tangent layout (matches MTK_BUILD_MANIFOLD field order, eskf.hpp:21-28):
  [0:3)  pos     [3:6)  rot (right perturbation: R' = R Exp(dtheta))
  [6:9)  vel     [9:12) omega (body rates)
  [12:15) acc    [15:18) alpha

Process model (eskf.hpp processModel :299-306):
  pos'   = pos + dt (vel + dt/2 acc)          rot' = rot Exp(dt (omega + dt/2 alpha))
  vel'   = vel + dt acc                       omega' = omega + dt alpha
  acc, alpha: random walk driven by jerk noise (processNoiseJacobian :330-338).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import FilterConfig
from ..geometry import so3

_DOF = 18


class ESKFState(NamedTuple):
    pos: jnp.ndarray  # [3]
    rot: jnp.ndarray  # [3, 3]
    vel: jnp.ndarray  # [3]
    omega: jnp.ndarray  # [3]
    acc: jnp.ndarray  # [3]
    alpha: jnp.ndarray  # [3]
    cov: jnp.ndarray  # [18, 18]
    last_time: jnp.ndarray  # []
    initialized: jnp.ndarray  # [] bool


def _initial_cov(cfg: FilterConfig, dtype) -> jnp.ndarray:
    """initialCovariance (eskf.hpp:253-263)."""
    stds = jnp.repeat(
        jnp.asarray(
            [
                cfg.init_position_std,
                cfg.init_rotation_std,
                cfg.init_velocity_std,
                cfg.init_angular_velocity_std,
                cfg.init_acceleration_std,
                cfg.init_angular_acceleration_std,
            ],
            dtype,
        ),
        3,
    )
    return jnp.diag(stds * stds)


def init_filter(cfg: FilterConfig = FilterConfig(), dtype=jnp.float32) -> ESKFState:
    return ESKFState(
        pos=jnp.zeros(3, dtype),
        rot=jnp.eye(3, dtype=dtype),
        vel=jnp.zeros(3, dtype),
        omega=jnp.zeros(3, dtype),
        acc=jnp.zeros(3, dtype),
        alpha=jnp.zeros(3, dtype),
        cov=_initial_cov(cfg, dtype),
        last_time=jnp.asarray(0.0, dtype),
        initialized=jnp.asarray(False),
    )


def _initialize(state: ESKFState, stamp, pos, rot, cfg: FilterConfig) -> ESKFState:
    """initialize (eskf.hpp:98-113): hard-set pose, zero rates, reset P."""
    dtype = state.pos.dtype
    return ESKFState(
        pos=pos,
        rot=rot,
        vel=jnp.zeros(3, dtype),
        omega=jnp.zeros(3, dtype),
        acc=jnp.zeros(3, dtype),
        alpha=jnp.zeros(3, dtype),
        cov=_initial_cov(cfg, dtype),
        last_time=jnp.asarray(stamp, dtype),
        initialized=jnp.asarray(True),
    )


def _right_jacobian(v: jnp.ndarray) -> jnp.ndarray:
    """SO(3) right Jacobian Jr(v): Exp(v + d) ~ Exp(v) Exp(Jr(v) d)."""
    theta_sq = jnp.sum(v * v, axis=-1)
    small = theta_sq < 1e-10
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    hat = so3.skew(v)
    hat2 = hat @ hat
    a = jnp.where(small, 0.5, (1.0 - jnp.cos(theta)) / safe_sq)
    b = jnp.where(small, 1.0 / 6.0, (theta - jnp.sin(theta)) / (safe_sq * theta))
    eye = jnp.eye(3, dtype=v.dtype)
    return eye - a * hat + b * hat2


def _predict_mean(state: ESKFState, dt) -> ESKFState:
    """x.oplus(f(x) * dt) (esekfom predict + eskf.hpp processModel)."""
    rot_vec = dt * (state.omega + 0.5 * dt * state.alpha)
    return state._replace(
        pos=state.pos + dt * (state.vel + 0.5 * dt * state.acc),
        rot=state.rot @ so3.exp(rot_vec),
        vel=state.vel + dt * state.acc,
        omega=state.omega + dt * state.alpha,
    )


def predict(state: ESKFState, dt, cfg: FilterConfig) -> ESKFState:
    """One covariance-propagating predict step
    (esekfom::esekf::predict, esekfom.hpp:275-403, specialized to this
    manifold). Right-perturbation error dynamics:

      dp' = dp + dt dv + dt^2/2 da
      dth' = Exp(dt w_e)^T dth + dt Jr(dt w_e)(dw + dt/2 dal),  w_e = omega + dt/2 alpha
      dv' = dv + dt da;  dw' = dw + dt dal

    Jerk noise enters acc/alpha (processNoiseJacobian, eskf.hpp:330-338).
    """
    dtype = state.pos.dtype
    dt = jnp.asarray(dt, dtype)
    new = _predict_mean(state, dt)

    eye = jnp.eye(3, dtype=dtype)
    rot_vec = dt * (state.omega + 0.5 * dt * state.alpha)
    f = jnp.zeros((_DOF, _DOF), dtype)
    f = f.at[0:3, 0:3].set(eye)
    f = f.at[0:3, 6:9].set(dt * eye)
    f = f.at[0:3, 12:15].set(0.5 * dt * dt * eye)
    jr = _right_jacobian(rot_vec)
    f = f.at[3:6, 3:6].set(so3.exp(rot_vec).T)
    f = f.at[3:6, 9:12].set(dt * jr)
    f = f.at[3:6, 15:18].set(0.5 * dt * dt * jr)
    f = f.at[6:9, 6:9].set(eye)
    f = f.at[6:9, 12:15].set(dt * eye)
    f = f.at[9:12, 9:12].set(eye)
    f = f.at[9:12, 15:18].set(dt * eye)
    f = f.at[12:15, 12:15].set(eye)
    f = f.at[15:18, 15:18].set(eye)

    cov = f @ state.cov @ f.T
    qlin = (dt * cfg.q_linear_jerk_std) ** 2
    qang = (dt * cfg.q_angular_jerk_std) ** 2
    noise = jnp.zeros(_DOF, dtype).at[12:15].set(qlin).at[15:18].set(qang)
    cov = cov + jnp.diag(noise)
    return new._replace(cov=cov, last_time=state.last_time + dt)


def _boxplus(state: ESKFState, dx: jnp.ndarray) -> ESKFState:
    return state._replace(
        pos=state.pos + dx[0:3],
        rot=state.rot @ so3.exp(dx[3:6]),
        vel=state.vel + dx[6:9],
        omega=state.omega + dx[9:12],
        acc=state.acc + dx[12:15],
        alpha=state.alpha + dx[15:18],
    )


def _boxminus(a: ESKFState, b: ESKFState) -> jnp.ndarray:
    """a [-] b in the tangent at b (MTK boxminus convention)."""
    return jnp.concatenate(
        [
            a.pos - b.pos,
            so3.log(b.rot.T @ a.rot),
            a.vel - b.vel,
            a.omega - b.omega,
            a.acc - b.acc,
            a.alpha - b.alpha,
        ]
    )


def update_iterated(
    state: ESKFState,
    meas_pos: jnp.ndarray,
    meas_rot: jnp.ndarray,
    cfg: FilterConfig,
    r_diag: jnp.ndarray = None,
) -> ESKFState:
    """Iterated EKF pose update (esekfom::update_iterated, esekfom.hpp:406+,
    maximum_iteration / convergence_limit from Options, eskf.hpp:66-67).

    h(x) = (pos, rot); H = [I_6 | 0]. Iterations re-evaluate the residual at
    the current iterate x_j and solve in the tangent of the *propagated*
    state: delta = K (r_j + H dx_j) - dx_j with dx_j = x_j [-] x_0.
    """
    dtype = state.pos.dtype
    if r_diag is None:
        r_diag = jnp.concatenate(
            [
                jnp.full((3,), cfg.r_position_std**2, dtype),
                jnp.full((3,), cfg.r_rotation_std**2, dtype),
            ]
        )
    r_diag = jnp.maximum(r_diag, 1e-12)  # sanitizeMeasurementNoise

    p = state.cov
    # H P H^T + R with H = [I6 | 0] -> top-left 6x6 of P
    s = p[:6, :6] + jnp.diag(r_diag)
    k = jnp.linalg.solve(s.T, p[:, :6].T).T  # [18, 6] Kalman gain

    def body(_, carry):
        x_j, _ = carry
        # residual z [-] h(x_j): position difference + body-frame rot log
        r = jnp.concatenate([meas_pos - x_j.pos, so3.log(x_j.rot.T @ meas_rot)])
        dx_j = _boxminus(x_j, state)
        delta = k @ (r + dx_j[:6]) - dx_j
        return (_boxplus(x_j, delta), jnp.max(jnp.abs(delta)))

    x_new, _ = jax.lax.fori_loop(
        0, cfg.maximum_iteration, body, (state, jnp.asarray(jnp.inf, dtype))
    )

    i18 = jnp.eye(_DOF, dtype=dtype)
    kh = jnp.zeros((_DOF, _DOF), dtype).at[:, :6].set(k)
    cov = (i18 - kh) @ p
    return x_new._replace(cov=cov)


@partial(jax.jit, static_argnames=("cfg",))
def process_measurement(
    state: ESKFState,
    stamp: jnp.ndarray,
    meas_pos: jnp.ndarray,
    meas_rot: jnp.ndarray,
    cfg: FilterConfig = FilterConfig(),
) -> Tuple[ESKFState, jnp.ndarray]:
    """processMeasurement (eskf.hpp:120-146): initialize on first call or
    when dt > max_dt; reject non-positive dt; otherwise predict + iterated
    update. Returns (state, accepted)."""
    dtype = state.pos.dtype
    stamp = jnp.asarray(stamp, dtype)
    dt = stamp - state.last_time

    fresh = _initialize(state, stamp, meas_pos, meas_rot, cfg)

    def do_update():
        st = predict(state, dt, cfg)
        st = update_iterated(st, meas_pos, meas_rot, cfg)
        return st._replace(last_time=stamp)

    needs_init = ~state.initialized | (dt > cfg.max_dt)
    reject = state.initialized & ((dt <= 0.0) | ~jnp.isfinite(dt)) & ~(dt > cfg.max_dt)

    updated = jax.lax.cond(needs_init | reject, lambda: state, do_update)
    out = jax.tree_util.tree_map(
        lambda a, b: jnp.where(needs_init, a, b), fresh, updated
    )
    out = jax.tree_util.tree_map(lambda a, b: jnp.where(reject, a, b), state, out)
    return out, ~reject


@partial(jax.jit, static_argnames=("cfg",))
def state_predict(
    state: ESKFState, stamp: jnp.ndarray, cfg: FilterConfig = FilterConfig()
) -> Tuple[ESKFState, jnp.ndarray]:
    """statePredict (eskf.hpp:149-170): dead-reckon to `stamp` (no update).
    Rejected (state unchanged) when uninitialized, dt <= 0, or dt > max_dt."""
    dtype = state.pos.dtype
    stamp = jnp.asarray(stamp, dtype)
    dt = stamp - state.last_time
    ok = state.initialized & (dt > 0.0) & jnp.isfinite(dt) & (dt <= cfg.max_dt)
    moved = predict(state, jnp.where(ok, dt, 0.0), cfg)._replace(last_time=stamp)
    out = jax.tree_util.tree_map(lambda a, b: jnp.where(ok, b, a), state, moved)
    return out, ok


class FutureRollout(NamedTuple):
    pos: jnp.ndarray  # [M, 3]
    quat: jnp.ndarray  # [M, 4] (w, x, y, z)
    mask: jnp.ndarray  # [M] step within the distance budget
    final_index: jnp.ndarray  # [] index of the last valid step


@partial(jax.jit, static_argnames=("cfg",))
def state_propagate(
    state: ESKFState, cfg: FilterConfig = FilterConfig()
) -> FutureRollout:
    """statePropagate (eskf.hpp:213-246): roll the mean forward in
    `propagate_step_dt`-second steps until `propagate_horizon_m` meters of
    travel, recording each future pose. Fixed `propagate_max_steps`
    capacity with masking replaces the dynamic while loop."""
    dtype = state.pos.dtype
    dt = jnp.asarray(cfg.propagate_step_dt, dtype)

    def step(carry, _):
        st, dist, alive = carry
        nxt = _predict_mean(st, dt)
        step_dis = jnp.linalg.norm(nxt.pos - st.pos)
        # reference breaks on vanishing steps (:233-236)
        alive = alive & jnp.isfinite(step_dis) & (step_dis >= 1e-12) & (
            dist < cfg.propagate_horizon_m
        )
        dist = dist + jnp.where(alive, step_dis, 0.0)
        st = jax.tree_util.tree_map(lambda a, b: jnp.where(alive, b, a), st, nxt)
        quat = so3.matrix_to_quat(st.rot)
        return (st, dist, alive), (st.pos, quat, alive)

    init = (state, jnp.asarray(0.0, dtype), state.initialized)
    _, (pos, quat, mask) = jax.lax.scan(
        step, init, None, length=cfg.propagate_max_steps
    )
    final_index = jnp.maximum(jnp.sum(mask) - 1, 0)
    return FutureRollout(pos, quat, mask, final_index.astype(jnp.int32))
