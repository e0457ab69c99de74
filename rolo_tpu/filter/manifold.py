"""Generic iterated error-state EKF on manifold compositions.

JAX re-design of the vendored IKFoM toolkit the reference ships
(/root/reference/include/rolo/eskf/IKFoM_toolkit/): MTK's manifold
primitives (vect / SO3 / S2, mtk/types/*.hpp), the MTK_BUILD_MANIFOLD
macro (mtk/build_manifold.hpp) and esekfom::esekf's predict /
update_iterated (esekfom/esekfom.hpp:275-700).

Where IKFoM generates boxplus/boxminus and the sub-manifold Jacobian
corrections with C++ templates and hand-derived per-type formulas, this
build composes them from three primitives and lets JAX AUTODIFF produce
every Jacobian: F = d/d(dx) [ f(x ⊞ dx) ⊟ f(x) ] at dx = 0, H likewise in
the measurement manifold — the exact linearization IKFoM hand-codes
(esekfom.hpp:275-403), derived mechanically for ANY state declaration.
A state is declared as (name -> manifold) pairs over a NamedTuple/dict
pytree; filters over different compositions are just different
declarations, and everything jits/vmaps.

filter/eskf.py remains the specialized 18-DoF pose instantiation used on
the hot path (hand-written mean propagation + analytic process Jacobian);
tests pin this generic machinery against it.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..geometry import so3


class Vect(NamedTuple):
    """R^n with additive boxplus (mtk/types/vect.hpp)."""

    n: int

    @property
    def dim(self) -> int:
        return self.n

    def boxplus(self, x, dx):
        return x + dx

    def boxminus(self, a, b):
        return a - b


class SO3(NamedTuple):
    """Rotation matrices with RIGHT tangent perturbation
    (mtk/types/SOn.hpp: R' = R Exp(dtheta))."""

    @property
    def dim(self) -> int:
        return 3

    def boxplus(self, x, dx):
        return x @ so3.exp(dx)

    def boxminus(self, a, b):
        return so3.log(b.T @ a)


class S2(NamedTuple):
    """Unit vectors in R^3, 2-dof tangent (mtk/types/S2.hpp): the tangent
    basis at x is an orthonormal pair spanning x^perp; boxplus rotates x by
    Exp(B(x) delta)."""

    @property
    def dim(self) -> int:
        return 2

    @staticmethod
    def _basis(x):
        """[3, 2] orthonormal basis of the tangent plane at unit x
        (branchless Householder-style construction)."""
        # pick the axis least aligned with x
        e = jnp.where(jnp.abs(x[0]) < 0.9, jnp.array([1.0, 0.0, 0.0], x.dtype),
                      jnp.array([0.0, 1.0, 0.0], x.dtype))
        b1 = jnp.cross(x, e)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
        b2 = jnp.cross(x, b1)
        return jnp.stack([b1, b2], axis=-1)

    def boxplus(self, x, dx):
        b = self._basis(x)
        return so3.exp(b @ dx) @ x

    def boxminus(self, a, b):
        # rotation taking b to a, expressed in b's tangent basis. NaN-safe
        # at a == b (the autodiff linearization point): |v| has no gradient
        # at 0, so the small branch returns the first-order w = v directly
        # (ang/|v| -> 1 as a -> b), double-where guarded.
        v = jnp.cross(b, a)
        s2 = jnp.sum(v * v)
        small = s2 < 1e-12
        s = jnp.sqrt(jnp.where(small, 1.0, s2))
        c = jnp.clip(jnp.dot(a, b), -1.0, 1.0)
        ang = jnp.arctan2(s, c)
        w = jnp.where(small, v, (ang / s) * v)
        bb = self._basis(b)
        return bb.T @ w


Declaration = Sequence[Tuple[str, object]]


def tangent_dim(decl: Declaration) -> int:
    return sum(m.dim for m in dict(decl).values())


def boxplus(decl: Declaration, x: Dict, dx: jnp.ndarray) -> Dict:
    """x ⊞ dx over the composite tangent (MTK_BUILD_MANIFOLD boxplus)."""
    out = dict(x)
    off = 0
    for name, m in decl:
        out[name] = m.boxplus(x[name], dx[off:off + m.dim])
        off += m.dim
    return out


def boxminus(decl: Declaration, a: Dict, b: Dict) -> jnp.ndarray:
    """a ⊟ b -> composite tangent vector."""
    parts = []
    for name, m in decl:
        parts.append(jnp.ravel(m.boxminus(a[name], b[name])))
    return jnp.concatenate(parts)


def _jac_through_boxminus(decl_out, decl_in, fn, x):
    """d/d(dx) [ fn(x ⊞ dx) ⊟ fn(x) ] at dx = 0 — the manifold Jacobian
    IKFoM hand-derives per sub-manifold (esekfom.hpp predict F / update H)."""
    fx = fn(x)

    def local(dx):
        return boxminus(decl_out, fn(boxplus(decl_in, x, dx)), fx)

    return jax.jacfwd(local)(jnp.zeros((tangent_dim(decl_in),), _dtype_of(x)))


def _dtype_of(x: Dict):
    return jax.tree_util.tree_leaves(x)[0].dtype


class GenericEKF(NamedTuple):
    """A declared filter: state manifold + process/measurement models.

    process(x, dt) -> x        (mean propagation on the manifold)
    measure(x) -> z_dict       (into the measurement manifold)
    """

    decl: Declaration
    process: Callable
    measure: Callable
    meas_decl: Declaration


def predict(ekf: GenericEKF, x: Dict, p: jnp.ndarray, q: jnp.ndarray, dt) -> Tuple[Dict, jnp.ndarray]:
    """esekf::predict (esekfom.hpp:275-403): mean propagation + covariance
    F P Fᵀ + Q with F from autodiff through boxminus."""
    f = lambda s: ekf.process(s, dt)
    fjac = _jac_through_boxminus(ekf.decl, ekf.decl, f, x)
    return f(x), fjac @ p @ fjac.T + q


def update_iterated(
    ekf: GenericEKF,
    x: Dict,
    p: jnp.ndarray,
    z: Dict,
    r: jnp.ndarray,
    iterations: int = 3,
) -> Tuple[Dict, jnp.ndarray]:
    """esekf::update_iterated (esekfom.hpp:406+): Gauss-Newton iterated
    measurement update; H recomputed per iterate, the error restated in the
    CURRENT iterate's tangent (the boxminus chain IKFoM calls L/J
    corrections falls out of re-linearizing at each iterate)."""
    n = tangent_dim(ekf.decl)
    x0 = x

    def body(_, carry):
        xi, _ = carry
        h = _jac_through_boxminus(ekf.meas_decl, ekf.decl, ekf.measure, xi)
        innov = boxminus(ekf.meas_decl, z, ekf.measure(xi))
        # error of the anchor state in the current iterate's tangent
        dx0 = boxminus(ekf.decl, x0, xi)
        # minimize ||d - dx0||²_P⁻¹ + ||innov - H d||²_R⁻¹ over the step d
        # in xi's tangent (Gauss-Newton on the MAP cost): d = dx0 +
        # K (innov - H dx0)
        s = h @ p @ h.T + r
        k = p @ h.T @ jnp.linalg.inv(s)
        dx = dx0 + k @ (innov - h @ dx0)
        xi = boxplus(ekf.decl, xi, dx)
        pi = (jnp.eye(n, dtype=p.dtype) - k @ h) @ p
        return xi, pi

    # note: the reference anchors the prior error the same way
    # (esekfom.hpp update_iterated's x_ vs x_propagated bookkeeping)
    xi, pi = jax.lax.fori_loop(0, iterations, body, (x, p))
    return xi, pi
