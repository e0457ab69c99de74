"""SE(3) rigid transforms as (R, t) pairs over jnp arrays.

JAX replacement for the reference's Eigen::Isometry3d plumbing and the
rotation-first se3 expmap (/root/reference/include/rot_gicp/so3/so3.hpp:80-104).

A transform is represented as a pair of arrays (rot [..., 3, 3], trans
[..., 3]) rather than 4x4 homogeneous matrices: XLA fuses the 3x3 matmul +
add better, and it avoids wasting lanes on the constant bottom row. Helpers
to/from 4x4 matrices exist for I/O and tests.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import so3


class SE3(NamedTuple):
    """Batched rigid transform: rot [..., 3, 3], trans [..., 3]."""

    rot: jnp.ndarray
    trans: jnp.ndarray

    @staticmethod
    def identity(batch_shape=(), dtype=jnp.float32) -> "SE3":
        rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))
        trans = jnp.zeros((*batch_shape, 3), dtype=dtype)
        return SE3(rot, trans)

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply `other` first)."""
        rot = self.rot @ other.rot
        trans = jnp.einsum("...ij,...j->...i", self.rot, other.trans) + self.trans
        return SE3(rot, trans)

    def inverse(self) -> "SE3":
        rt = jnp.swapaxes(self.rot, -1, -2)
        return SE3(rt, -jnp.einsum("...ij,...j->...i", rt, self.trans))

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        """Transform points: [..., 3] (single, matching batch) or [..., N, 3]."""
        if points.ndim == self.trans.ndim:
            return jnp.einsum("...ij,...j->...i", self.rot, points) + self.trans
        return jnp.einsum("...ij,...nj->...ni", self.rot, points) + self.trans[..., None, :]

    def as_matrix(self) -> jnp.ndarray:
        """-> [..., 4, 4] homogeneous matrix."""
        batch = self.rot.shape[:-2]
        m = jnp.zeros((*batch, 4, 4), dtype=self.rot.dtype)
        m = m.at[..., :3, :3].set(self.rot)
        m = m.at[..., :3, 3].set(self.trans)
        m = m.at[..., 3, 3].set(1.0)
        return m

    @staticmethod
    def from_matrix(m: jnp.ndarray) -> "SE3":
        return SE3(m[..., :3, :3], m[..., :3, 3])

    @staticmethod
    def from_xyzrpy(vec: jnp.ndarray) -> "SE3":
        """[..., 6] (x, y, z, roll, pitch, yaw) -> SE3. Matches pcl::getTransformation."""
        rot = so3.rpy_to_matrix(vec[..., 3], vec[..., 4], vec[..., 5])
        return SE3(rot, vec[..., :3])

    def to_xyzrpy(self) -> jnp.ndarray:
        roll, pitch, yaw = so3.matrix_to_rpy(self.rot)
        return jnp.concatenate(
            [self.trans, jnp.stack([roll, pitch, yaw], axis=-1)], axis=-1
        )


def transform_points(rot: jnp.ndarray, trans: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """pts [N, 3] -> R @ p + t. Broadcasts over leading batch dims of (rot, trans)."""
    return jnp.einsum("...ij,...nj->...ni", rot, pts) + trans[..., None, :]


def exp(xi: jnp.ndarray) -> SE3:
    """Rotation-first se(3) expmap: xi = [omega, rho] [..., 6] -> SE3.

    Mirrors fast_gicp::se3_exp (so3.hpp:80-104): R = exp(omega),
    t = V(omega) @ rho with the standard left-Jacobian V.
    """
    omega = xi[..., :3]
    rho = xi[..., 3:]
    theta_sq = jnp.sum(omega * omega, axis=-1)
    small = theta_sq < 1e-10
    # Double-where: the dead branch must stay NaN/inf-free under autodiff
    # (1/max(x, tiny) has a NaN cotangent at x=0 because max(x,tiny)^2
    # underflows f32).
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    rot = so3.exp(omega)
    omega_hat = so3.skew(omega)
    omega_sq = omega_hat @ omega_hat

    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), omega_hat.shape)
    a = jnp.where(small, 0.5, (1.0 - jnp.cos(theta)) / safe_sq)
    b = jnp.where(small, 1.0 / 6.0, (theta - jnp.sin(theta)) / (safe_sq * theta))
    v = eye + a[..., None, None] * omega_hat + b[..., None, None] * omega_sq
    # Reference uses V = R for the small-angle branch (so3.hpp:91-93); the
    # series above is the exact expansion and agrees to O(theta^2).
    trans = jnp.einsum("...ij,...j->...i", v, rho)
    return SE3(rot, trans)


def log(t: SE3) -> jnp.ndarray:
    """Inverse of exp: SE3 -> [..., 6] (omega, rho).

    Double-where guarded so autodiff at the identity is NaN-free (the
    pose-graph solver takes jacrev through this at zero residual).
    """
    omega = so3.log(t.rot)
    theta_sq = jnp.sum(omega * omega, axis=-1)
    small = theta_sq < 1e-10
    safe_sq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_sq)
    omega_hat = so3.skew(omega)
    omega_sq = omega_hat @ omega_hat
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), omega_hat.shape)
    half_theta = 0.5 * theta
    # V^{-1} = I - 0.5*hat + (1/theta^2)(1 - theta*cos(t/2)/(2 sin(t/2))) hat^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.sin(half_theta)) / safe_sq,
    )
    v_inv = eye - 0.5 * omega_hat + cot_term[..., None, None] * omega_sq
    rho = jnp.einsum("...ij,...j->...i", v_inv, t.trans)
    return jnp.concatenate([omega, rho], axis=-1)


def rigid_align(src: jnp.ndarray, dst: jnp.ndarray, weights: jnp.ndarray = None) -> SE3:
    """Weighted Kabsch/Umeyama: the SE3 minimizing sum w |T(src) - dst|^2
    (ComputeRigidAlignment, prior_pose_node.cpp:29-64; also the per-iteration
    pose re-estimation inside loop-closure ICP). src, dst: [N, 3]."""
    dtype = src.dtype
    w = jnp.ones(src.shape[0], dtype) if weights is None else jnp.asarray(weights, dtype)
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    cs = jnp.einsum("n,ni->i", w, src) / wsum
    cd = jnp.einsum("n,ni->i", w, dst) / wsum
    h = jnp.einsum("n,ni,nj->ij", w, src - cs, dst - cd)
    u, _, vt = jnp.linalg.svd(h)
    d = jnp.linalg.det(vt.T @ u.T)
    s = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], dtype)).at[2, 2].set(d)
    rot = vt.T @ s @ u.T
    return SE3(rot, cd - rot @ cs)
