"""SO(3) primitives: skew, exponential/log maps, quaternion utilities.

JAX re-design of the reference's Sophus-derived helpers
(/root/reference/include/rot_gicp/so3/so3.hpp:9-104 and the MTK SO3 type
include/rolo/eskf/IKFoM_toolkit/mtk/types/SOn.hpp). Everything here is pure
jnp, shape-polymorphic over leading batch dims, and safe to vmap/jit.

Conventions:
  - Rotation matrices are [..., 3, 3], acting on column vectors.
  - Quaternions are [..., 4] in (w, x, y, z) order.
  - Tangent vectors omega are [..., 3] (axis-angle, radians).
"""

from __future__ import annotations

import jax.numpy as jnp

_SMALL = 1e-10  # matches the reference's small-angle series cutoff (so3.hpp:64)


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] cross-product matrix (so3.hpp:9-31)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def unskew(m: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] -> [..., 3]; inverse of skew for antisymmetric m."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def exp_quat(omega: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle [..., 3] -> unit quaternion [..., 4] (w,x,y,z).

    Small-angle Taylor series mirrors so3.hpp:58-77 so numerics agree with
    the reference near zero.
    """
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta_sq, _SMALL))  # guarded; series used below cutoff
    half = 0.5 * theta
    theta_quad = theta_sq * theta_sq
    imag_series = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
    real_series = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    use_series = theta_sq < _SMALL
    imag = jnp.where(use_series, imag_series, jnp.sin(half) / theta)
    real = jnp.where(use_series, real_series, jnp.cos(half))
    return jnp.concatenate([real[..., None], imag[..., None] * omega], axis=-1)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1)
    row1 = jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1)
    row2 = jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_quat(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w,x,y,z).

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select the best-conditioned one (largest pivot) with jnp.where.
    """
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (guaranteed >= 0 pre-max).
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    qw = jnp.maximum(qw, 1e-12)
    s = 2.0 * jnp.sqrt(qw)  # [..., 4]

    c0 = jnp.stack([s[..., 0] / 4.0, (m21 - m12) / s[..., 0], (m02 - m20) / s[..., 0], (m10 - m01) / s[..., 0]], axis=-1)
    c1 = jnp.stack([(m21 - m12) / s[..., 1], s[..., 1] / 4.0, (m01 + m10) / s[..., 1], (m02 + m20) / s[..., 1]], axis=-1)
    c2 = jnp.stack([(m02 - m20) / s[..., 2], (m01 + m10) / s[..., 2], s[..., 2] / 4.0, (m12 + m21) / s[..., 2]], axis=-1)
    c3 = jnp.stack([(m10 - m01) / s[..., 3], (m02 + m20) / s[..., 3], (m12 + m21) / s[..., 3], s[..., 3] / 4.0], axis=-1)

    best = jnp.argmax(qw, axis=-1)
    cands = jnp.stack([c0, c1, c2, c3], axis=-2)  # [..., 4(cand), 4(comp)]
    q = jnp.take_along_axis(cands, best[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    # Canonicalize to w >= 0 so downstream log() yields the principal rotvec.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues)."""
    return quat_to_matrix(exp_quat(omega))


def log(r: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3].

    Uses the quaternion route for stability near identity. Written with the
    double-where pattern so jax.grad/jacrev are NaN-free at the identity
    (the pose-graph solver differentiates through log at zero residual).
    """
    q = matrix_to_quat(r)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    n2 = jnp.sum(vec * vec, axis=-1)
    small = n2 < 1e-14
    safe_n2 = jnp.where(small, 1.0, n2)  # keeps sqrt grad finite on the dead branch
    vec_norm = jnp.sqrt(safe_n2)
    theta = 2.0 * jnp.arctan2(vec_norm, w)
    # small-angle: theta/|vec| -> 2/w - series; constant 2/w suffices to O(n2)
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-9), theta / vec_norm)
    return vec * scale[..., None]


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v [..., 3] by quaternion q [..., 4]."""
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + q[..., :1] * t + jnp.cross(qv, t)


def rpy_to_matrix(roll, pitch, yaw) -> jnp.ndarray:
    """Euler RPY (extrinsic x-y-z / intrinsic ZYX) -> rotation matrix.

    Matches pcl::getTransformation / tf::createQuaternionFromRPY:
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
    """
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_rpy(r: jnp.ndarray):
    """Rotation matrix -> (roll, pitch, yaw), inverse of rpy_to_matrix.

    Matches Eigen/pcl getTranslationAndEulerAngles conventions.
    """
    sp = -r[..., 2, 0]
    sp = jnp.clip(sp, -1.0, 1.0)
    pitch = jnp.arcsin(sp)
    roll = jnp.arctan2(r[..., 2, 1], r[..., 2, 2])
    yaw = jnp.arctan2(r[..., 1, 0], r[..., 0, 0])
    return roll, pitch, yaw
