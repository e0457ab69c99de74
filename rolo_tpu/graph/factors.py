"""Pose-graph factor containers (fixed-capacity, masked).

JAX replacement for the reference's GTSAM factor plumbing
(/root/reference/src/backMapping.cpp:1224-1284): the odometry chain, the
first-pose prior, and between-factor queues for loop closures and
ground-contact priors. Factors are stored as parallel arrays so the solver
is pure gather/scatter.

Noise conventions follow GTSAM: per-factor diagonal *variances* in tangent
order (rx, ry, rz, tx, ty, tz); robust_c > 0 marks a Cauchy robust kernel
(the SC-loop noise model, backMapping.cpp:2464-2476).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# addOdomFactor noise (backMapping.cpp:1229, 1235). The reference's
# first-pose prior is nearly gauge-free in (yaw, x, y, z) (variances pi^2 /
# 1e8); iSAM2 keeps the gauge pinned only because it rarely relinearizes
# pose 0. A batch GN re-solve would let the whole trajectory drift in those
# directions, so the anchored variant below pins pose 0 firmly — a pure
# gauge choice with no effect on relative trajectory / ATE.
FIRST_PRIOR_VARIANCES_REFERENCE = (1e-2, 1e-2, 9.8696044, 1e8, 1e8, 1e8)
FIRST_PRIOR_VARIANCES = (1e-6, 1e-6, 1e-6, 1e-6, 1e-6, 1e-6)
ODOM_VARIANCES = (1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4)


class BetweenFactors(NamedTuple):
    """Fixed-capacity between-factor set: T_i^{-1} T_j should equal Z."""

    i: jnp.ndarray  # [L] int32
    j: jnp.ndarray  # [L] int32
    rel_rot: jnp.ndarray  # [L, 3, 3] measured Z rotation
    rel_trans: jnp.ndarray  # [L, 3]
    noise_var: jnp.ndarray  # [L, 6] diagonal variances (tangent order w, t)
    robust_c: jnp.ndarray  # [L] Cauchy k (0 = gaussian)
    valid: jnp.ndarray  # [L]
    count: jnp.ndarray  # [] int32

    @property
    def capacity(self) -> int:
        return self.i.shape[0]


def empty_between(capacity: int, dtype=jnp.float32) -> BetweenFactors:
    return BetweenFactors(
        i=jnp.zeros((capacity,), jnp.int32),
        j=jnp.zeros((capacity,), jnp.int32),
        rel_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (capacity, 3, 3)),
        rel_trans=jnp.zeros((capacity, 3), dtype=dtype),
        noise_var=jnp.ones((capacity, 6), dtype=dtype),
        robust_c=jnp.zeros((capacity,), dtype=dtype),
        valid=jnp.zeros((capacity,), bool),
        count=jnp.asarray(0, jnp.int32),
    )


def add_between(
    f: BetweenFactors,
    i: jnp.ndarray,
    j: jnp.ndarray,
    rel_rot: jnp.ndarray,
    rel_trans: jnp.ndarray,
    noise_var: jnp.ndarray,
    robust_c: jnp.ndarray = None,
    enable: jnp.ndarray = True,
) -> BetweenFactors:
    """Append one factor (no-op when `enable` is False or at capacity)."""
    idx = jnp.minimum(f.count, f.capacity - 1)
    ok = jnp.asarray(enable) & (f.count < f.capacity)

    def upd(arr, val):
        return jnp.where(ok, arr.at[idx].set(val), arr)

    rc = jnp.asarray(0.0, f.robust_c.dtype) if robust_c is None else robust_c
    return BetweenFactors(
        i=upd(f.i, jnp.asarray(i, jnp.int32)),
        j=upd(f.j, jnp.asarray(j, jnp.int32)),
        rel_rot=upd(f.rel_rot, rel_rot),
        rel_trans=upd(f.rel_trans, rel_trans),
        noise_var=upd(f.noise_var, noise_var),
        robust_c=upd(f.robust_c, rc),
        valid=upd(f.valid, True),
        count=jnp.where(ok, f.count + 1, f.count),
    )


class PoseGraph(NamedTuple):
    """Complete factor-graph state carried by the back-end.

    The odometry chain is implicit: odom_rel_{k} constrains pose k-1 -> k
    for 1 <= k < count (addOdomFactor). first_* is the k=0 prior.
    """

    odom_rel_rot: jnp.ndarray  # [K, 3, 3]
    odom_rel_trans: jnp.ndarray  # [K, 3]
    first_rot: jnp.ndarray  # [3, 3]
    first_trans: jnp.ndarray  # [3]
    loops: BetweenFactors
    priors: BetweenFactors


def empty_graph(max_keyframes: int, max_loops: int, max_priors: int, dtype=jnp.float32) -> PoseGraph:
    return PoseGraph(
        odom_rel_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (max_keyframes, 3, 3)),
        odom_rel_trans=jnp.zeros((max_keyframes, 3), dtype=dtype),
        first_rot=jnp.eye(3, dtype=dtype),
        first_trans=jnp.zeros(3, dtype=dtype),
        loops=empty_between(max_loops, dtype),
        priors=empty_between(max_priors, dtype),
    )
