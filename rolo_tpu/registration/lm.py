"""Levenberg-Marquardt drivers for rot-GICP as jittable while-loops.

JAX re-design of LsqRegistration
(/root/reference/include/rot_gicp/gicp/impl/lsq_registration_impl.hpp):
  - rotation-only SO(3) LM (rot_step_lm, :272-324) — the default optimizer,
  - full SE(3) LM (step_lm, :225-270) and Gauss-Newton (step_gn, :207-222),
  - continuous-time translation LM (step_t_optimize, :84-139).

The reference's nested loops (<=64 outer linearizations x <=10 inner lambda
trials, :152-179) map onto lax.while_loop with the same accept/reject rho
logic and the same convergence tests, so a jit/vmap over thousands of scan
pairs compiles to a single masked program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import so3, se3
from ..ops.linalg import solve_psd
from . import gicp
from .gicp import Correspondences, GICPContext

# Defaults from lsq_registration_impl.hpp:11-19.
MAX_OUTER = 64
MAX_INNER = 10
INIT_LAMBDA_FACTOR = 1e-9
ROTATION_EPS = 2e-3
TRANSFORM_EPS = 5e-4


class LMResult(NamedTuple):
    rot: jnp.ndarray  # [3, 3]
    trans: jnp.ndarray  # [3]
    hessian: jnp.ndarray  # final H (3x3 for SO3, 6x6 for SE3/CT)
    error: jnp.ndarray  # last linearization error
    iterations: jnp.ndarray  # outer iterations executed
    converged: jnp.ndarray  # bool
    failed: jnp.ndarray  # bool: inner loop exhausted without progress


def _rot_small(delta_rot: jnp.ndarray, rot_eps: float) -> jnp.ndarray:
    """is_rot_converged (lsq_registration_impl.hpp:327-335)."""
    return jnp.max(jnp.abs(delta_rot - jnp.eye(3, dtype=delta_rot.dtype))) / rot_eps < 1.0


def _trans_small(delta_t: jnp.ndarray, trans_eps: float) -> jnp.ndarray:
    """is_t_converged (lsq_registration_impl.hpp:141-148)."""
    return jnp.max(jnp.abs(delta_t)) / trans_eps < 1.0


def _lm_inner(h, b, y0, lam0, try_step, small_step, max_inner):
    """Shared inner lambda-trial loop (impl:100-139 / :234-270 / :286-324).

    try_step(d) -> (candidate state, delta) applies the solved step;
    small_step(delta) -> bool is the convergence test on the *delta*.
    Returns (accepted state or None, new lambda, done, converged, delta).
    """

    def cond(s):
        i, _, _, _, done, _, _ = s
        return (i < max_inner) & ~done

    def body(s):
        i, lam, nu, state, done, conv, _ = s
        n = h.shape[0]
        d = solve_psd(h + lam * jnp.eye(n, dtype=h.dtype), -b)
        cand, delta, yi = try_step(d)
        denom = jnp.dot(d, lam * d - b)
        rho = (y0 - yi) / denom
        accept = rho >= 0  # note: NaN rho (degenerate) routes to reject
        small = small_step(delta)

        lam_acc = lam * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_rej = nu * lam
        new_lam = jnp.where(accept, lam_acc, lam_rej)
        new_nu = jnp.where(accept, nu, 2.0 * nu)
        # reject + tiny delta -> converged without updating the state
        new_done = accept | (small & ~accept)
        new_conv = small
        new_state = jax.tree.map(
            lambda c, old: jnp.where(accept, c, old), cand, state
        )
        return (i + 1, new_lam, new_nu, new_state, new_done, new_conv, delta)

    return cond, body


def lm_register_rotation(
    ctx: GICPContext,
    rot0: jnp.ndarray,
    trans0: jnp.ndarray,
    max_outer: int = MAX_OUTER,
    max_inner: int = MAX_INNER,
    rot_eps: float = ROTATION_EPS,
    trans_eps: float = TRANSFORM_EPS,
    init_lambda_factor: float = INIT_LAMBDA_FACTOR,
    linearize_fn=None,
    error_fn=None,
) -> LMResult:
    """Rotation registration: SO(3) LM over the rot-GICP objective
    (computeTransformation + rot_step_lm). Correspondences are re-bound at
    every outer linearization, exactly like so3_linearize.

    linearize_fn/error_fn override the objective reductions — the SPMD
    point-sharded path (parallel/spmd.py) wraps the defaults with psums so
    the same driver runs with the source cloud split across a mesh axis."""
    linearize = linearize_fn if linearize_fn is not None else gicp.so3_linearize
    error = error_fn if error_fn is not None else gicp.compute_error

    def outer_cond(s):
        it, _, _, lam, conv, failed, _, _ = s
        return (it < max_outer) & ~conv & ~failed

    def outer_body(s):
        it, rot, trans, lam, conv, failed, _, _ = s
        corr = gicp.update_correspondences(ctx, rot, trans)
        y0, h, b = linearize(ctx, corr, rot, trans)
        lam = jnp.where(lam < 0, init_lambda_factor * jnp.max(jnp.abs(jnp.diag(h))), lam)

        def try_step(d):
            delta_rot = so3.exp(d)
            cand_rot = delta_rot @ rot
            cand_trans = delta_rot @ trans
            yi = error(ctx, corr, cand_rot, cand_trans)
            return (cand_rot, cand_trans), delta_rot, yi

        cond, body = _lm_inner(
            h, b, y0, lam, try_step, partial(_rot_small, rot_eps=rot_eps), max_inner
        )
        init = (0, lam, 2.0, (rot, trans), jnp.array(False), jnp.array(False), jnp.eye(3, dtype=rot.dtype))
        i, lam, _, (rot, trans), done, conv_in, delta = jax.lax.while_loop(cond, body, init)
        # outer convergence: is_converged on the step's delta (impl:164-174)
        new_conv = done & _rot_small(delta, rot_eps)
        new_failed = ~done
        return (it + 1, rot, trans, lam, new_conv, new_failed, h, y0)

    h0 = jnp.eye(3, dtype=rot0.dtype)
    state = (0, rot0, trans0, jnp.asarray(-1.0, rot0.dtype), jnp.array(False), jnp.array(False), h0, jnp.asarray(0.0, rot0.dtype))
    it, rot, trans, lam, conv, failed, h, err = jax.lax.while_loop(outer_cond, outer_body, state)
    return LMResult(rot, trans, h, err, it, conv, failed)


def lm_register_se3(
    ctx: GICPContext,
    rot0: jnp.ndarray,
    trans0: jnp.ndarray,
    max_outer: int = MAX_OUTER,
    max_inner: int = MAX_INNER,
    rot_eps: float = ROTATION_EPS,
    trans_eps: float = TRANSFORM_EPS,
    init_lambda_factor: float = INIT_LAMBDA_FACTOR,
) -> LMResult:
    """Full SE(3) LM (step_lm path, optimizer type LevenbergMarquardt)."""

    def small_delta(delta):
        d_rot, d_trans = delta
        return _rot_small(d_rot, rot_eps) & _trans_small(d_trans, trans_eps)

    def outer_cond(s):
        it, _, _, lam, conv, failed, _, _ = s
        return (it < max_outer) & ~conv & ~failed

    def outer_body(s):
        it, rot, trans, lam, conv, failed, _, _ = s
        corr = gicp.update_correspondences(ctx, rot, trans)
        y0, h, b = gicp.se3_linearize(ctx, corr, rot, trans)
        lam = jnp.where(lam < 0, init_lambda_factor * jnp.max(jnp.abs(jnp.diag(h))), lam)

        def try_step(d):
            dT = se3.exp(d)
            cand_rot = dT.rot @ rot
            cand_trans = dT.rot @ trans + dT.trans
            yi = gicp.compute_error(ctx, corr, cand_rot, cand_trans)
            return (cand_rot, cand_trans), (dT.rot, dT.trans), yi

        cond, body = _lm_inner(h, b, y0, lam, try_step, small_delta, max_inner)
        init = (
            0, lam, 2.0, (rot, trans), jnp.array(False), jnp.array(False),
            (jnp.eye(3, dtype=rot.dtype), jnp.zeros(3, rot.dtype)),
        )
        i, lam, _, (rot, trans), done, conv_in, delta = jax.lax.while_loop(cond, body, init)
        new_conv = done & small_delta(delta)
        new_failed = ~done
        return (it + 1, rot, trans, lam, new_conv, new_failed, h, y0)

    h0 = jnp.eye(6, dtype=rot0.dtype)
    state = (0, rot0, trans0, jnp.asarray(-1.0, rot0.dtype), jnp.array(False), jnp.array(False), h0, jnp.asarray(0.0, rot0.dtype))
    it, rot, trans, lam, conv, failed, h, err = jax.lax.while_loop(outer_cond, outer_body, state)
    return LMResult(rot, trans, h, err, it, conv, failed)


def gn_register_se3(
    ctx: GICPContext,
    rot0: jnp.ndarray,
    trans0: jnp.ndarray,
    max_outer: int = MAX_OUTER,
    rot_eps: float = ROTATION_EPS,
    trans_eps: float = TRANSFORM_EPS,
) -> LMResult:
    """Plain Gauss-Newton SE(3) registration (optimizer type GaussNewton,
    step_gn, lsq_registration_impl.hpp:207-222): solve H d = -b and always
    accept — no lambda damping, no accept/reject. Converges faster per
    iteration than LM on well-conditioned problems; kept for parity with the
    reference's LSQ_OPTIMIZER_TYPE enum (lsq_registration.hpp:13)."""

    def small_delta(d_rot, d_trans):
        return _rot_small(d_rot, rot_eps) & _trans_small(d_trans, trans_eps)

    def cond(s):
        it, _, _, conv, _, _ = s
        return (it < max_outer) & ~conv

    def body(s):
        it, rot, trans, conv, _, _ = s
        corr = gicp.update_correspondences(ctx, rot, trans)
        y0, h, b = gicp.se3_linearize(ctx, corr, rot, trans)
        d = solve_psd(h, -b)
        dT = se3.exp(d)
        rot = dT.rot @ rot
        trans = dT.rot @ trans + dT.trans
        return (it + 1, rot, trans, small_delta(dT.rot, dT.trans), h, y0)

    state = (
        0, rot0, trans0, jnp.array(False),
        jnp.eye(6, dtype=rot0.dtype), jnp.asarray(0.0, rot0.dtype),
    )
    it, rot, trans, conv, h, err = jax.lax.while_loop(cond, body, state)
    return LMResult(rot, trans, h, err, it, conv, jnp.array(False))


class CTResult(NamedTuple):
    trans: jnp.ndarray  # [3] solved translation (the reference's t0)
    hessian: jnp.ndarray  # [6, 6]
    error: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    failed: jnp.ndarray


def lm_translation(
    ctx: GICPContext,
    corr: Correspondences,
    t0: jnp.ndarray,
    init_guess: jnp.ndarray,
    last_t0: jnp.ndarray,
    interval_tn,
    interval_tn_1,
    ct_lambda: float,
    max_outer: int = MAX_OUTER,
    max_inner: int = MAX_INNER,
    trans_eps: float = TRANSFORM_EPS,
    init_lambda_factor: float = INIT_LAMBDA_FACTOR,
    ct_linearize_fn=None,
    ct_error_fn=None,
) -> CTResult:
    """Continuous-time translation NLS (computeTranslation,
    lsq_registration_impl.hpp:54-80 + step_t_optimize :84-139).

    Reuses `corr` from the final rotation linearization — the reference
    never updates correspondences during this solve. Solves a 6-dof system
    but retracts only the translational part of se3_exp(d) (:105-106).

    ct_linearize_fn/ct_error_fn override the objective reductions (psum
    wrappers for the point-sharded SPMD path, parallel/spmd.py)."""
    ct_lin = ct_linearize_fn if ct_linearize_fn is not None else gicp.ct_linearize
    ct_err = ct_error_fn if ct_error_fn is not None else gicp.ct_error
    interval_tn = jnp.asarray(interval_tn, t0.dtype)
    interval_tn_1 = jnp.asarray(interval_tn_1, t0.dtype)

    def outer_cond(s):
        it, _, lam, conv, failed, _, _ = s
        return (it < max_outer) & ~conv & ~failed

    def outer_body(s):
        it, t, lam, conv, failed, _, _ = s
        y0, h, b = ct_lin(
            ctx, corr, t, init_guess, last_t0, interval_tn, interval_tn_1, ct_lambda
        )
        lam = jnp.where(lam < 0, init_lambda_factor * jnp.max(jnp.abs(jnp.diag(h))), lam)

        def try_step(d):
            delta_t = se3.exp(d).trans
            cand = t + delta_t
            yi = ct_err(
                ctx, corr, cand, init_guess, last_t0, interval_tn, interval_tn_1, ct_lambda
            )
            return (cand,), delta_t, yi

        cond, body = _lm_inner(
            h, b, y0, lam, try_step, partial(_trans_small, trans_eps=trans_eps), max_inner
        )
        init = (0, lam, 2.0, (t,), jnp.array(False), jnp.array(False), jnp.zeros(3, t.dtype))
        i, lam, _, (t,), done, conv_in, delta = jax.lax.while_loop(cond, body, init)
        new_conv = done & _trans_small(delta, trans_eps)
        new_failed = ~done
        return (it + 1, t, lam, new_conv, new_failed, h, y0)

    h0 = jnp.eye(6, dtype=t0.dtype)
    state = (0, t0, jnp.asarray(-1.0, t0.dtype), jnp.array(False), jnp.array(False), h0, jnp.asarray(0.0, t0.dtype))
    it, t, lam, conv, failed, h, err = jax.lax.while_loop(outer_cond, outer_body, state)
    return CTResult(t, h, err, it, conv, failed)


def lm_translation_rebind(
    ctx: GICPContext,
    rot: jnp.ndarray,
    t0: jnp.ndarray,
    init_guess: jnp.ndarray,
    last_t0: jnp.ndarray,
    interval_tn,
    interval_tn_1,
    ct_lambda: float,
    rebind_rounds: int = 4,
    max_outer: int = MAX_OUTER,
    max_inner: int = MAX_INNER,
    trans_eps: float = TRANSFORM_EPS,
    init_lambda_factor: float = INIT_LAMBDA_FACTOR,
    ct_linearize_fn=None,
    ct_error_fn=None,
) -> CTResult:
    """CT translation with correspondence rebinding between solve rounds.

    The reference binds correspondences once for the whole translation
    solve (the rebind inside t3_linearize is commented out,
    rot_vgicp_impl.hpp:509-512), which caps how much translation error a
    single scan can recover — its accuracy rests on the forward location
    prediction staying inside one binding's pull. Here a rebind is just
    another batch of voxel lookups, so this driver re-binds at the current
    translation and re-solves, up to `rebind_rounds` times, stopping early
    once a round no longer moves the estimate. rebind_rounds=1 reproduces
    the reference exactly."""

    def do_round(t):
        corr = gicp.update_correspondences(ctx, rot, t)
        return lm_translation(
            ctx, corr, t, init_guess, last_t0, interval_tn, interval_tn_1,
            ct_lambda, max_outer=max_outer, max_inner=max_inner,
            trans_eps=trans_eps, init_lambda_factor=init_lambda_factor,
            ct_linearize_fn=ct_linearize_fn, ct_error_fn=ct_error_fn,
        )

    first = do_round(t0)
    if rebind_rounds <= 1:
        return first

    def cond(s):
        rnd, res, moved = s
        return (rnd < rebind_rounds) & moved

    def body(s):
        rnd, res, _ = s
        nxt = do_round(res.trans)
        moved = jnp.max(jnp.abs(nxt.trans - res.trans)) > 10.0 * trans_eps
        nxt = nxt._replace(iterations=res.iterations + nxt.iterations)
        return (rnd + 1, nxt, moved)

    _, res, _ = jax.lax.while_loop(cond, body, (1, first, jnp.array(True)))
    return res
