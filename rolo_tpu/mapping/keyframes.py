"""Keyframe database as preallocated ring-buffered arrays.

JAX re-design of backMapping's keyframe state
(/root/reference/src/backMapping.cpp:115-122: cloudKeyPoses3D/6D +
cornerCloudKeyFrames/surfCloudKeyFrames): fixed-capacity arrays with a
count, so submap assembly is a masked gather instead of pointer chasing,
and the whole DB (poses + clouds) is a serializable pytree — the natural
checkpoint/resume unit (SURVEY.md section 5).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..geometry.se3 import SE3
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample


class KeyframeDB(NamedTuple):
    """poses: world-frame keyframe poses; clouds: sensor-frame features."""

    rot: jnp.ndarray  # [K, 3, 3]
    trans: jnp.ndarray  # [K, 3]
    time: jnp.ndarray  # [K]
    corner_xyz: jnp.ndarray  # [K, C, 3]
    corner_mask: jnp.ndarray  # [K, C]
    surf_xyz: jnp.ndarray  # [K, S, 3]
    surf_mask: jnp.ndarray  # [K, S]
    count: jnp.ndarray  # [] int32

    @property
    def capacity(self) -> int:
        return self.rot.shape[0]

    def valid(self) -> jnp.ndarray:
        return jnp.arange(self.capacity) < self.count


def init_db(max_keyframes: int, corner_cap: int, surf_cap: int, dtype=jnp.float32) -> KeyframeDB:
    k = max_keyframes
    return KeyframeDB(
        rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (k, 3, 3)),
        trans=jnp.zeros((k, 3), dtype=dtype),
        time=jnp.zeros((k,), dtype=dtype),
        corner_xyz=jnp.zeros((k, corner_cap, 3), dtype=dtype),
        corner_mask=jnp.zeros((k, corner_cap), dtype=bool),
        surf_xyz=jnp.zeros((k, surf_cap, 3), dtype=dtype),
        surf_mask=jnp.zeros((k, surf_cap), dtype=bool),
        count=jnp.asarray(0, jnp.int32),
    )


def add_keyframe(
    db: KeyframeDB,
    pose: SE3,
    time: jnp.ndarray,
    corner: PaddedCloud,
    surf: PaddedCloud,
) -> KeyframeDB:
    """Append a keyframe (saveKeyFramesAndFactor, backMapping.cpp:1131-1181).
    Silently drops if at capacity (mirror of unbounded std::vector growth is
    impossible with static shapes; capacity is a config knob)."""
    idx = jnp.minimum(db.count, db.capacity - 1)
    at_cap = db.count >= db.capacity

    def upd(arr, val):
        new = arr.at[idx].set(val)
        return jnp.where(at_cap, arr, new)

    return KeyframeDB(
        rot=upd(db.rot, pose.rot),
        trans=upd(db.trans, pose.trans),
        time=upd(db.time, time),
        corner_xyz=upd(db.corner_xyz, corner.xyz),
        corner_mask=upd(db.corner_mask, corner.mask),
        surf_xyz=upd(db.surf_xyz, surf.xyz),
        surf_mask=upd(db.surf_mask, surf.mask),
        count=jnp.where(at_cap, db.count, db.count + 1),
    )


def should_add_keyframe(
    db: KeyframeDB,
    pose: SE3,
    dist_threshold: float,
    angle_threshold: float,
) -> jnp.ndarray:
    """saveFrame gate (backMapping.cpp:1071-1091): add when the relative
    motion from the last keyframe exceeds distance OR any rpy angle."""
    last = SE3(db.rot[jnp.maximum(db.count - 1, 0)], db.trans[jnp.maximum(db.count - 1, 0)])
    between = last.inverse().compose(pose)
    xyzrpy = between.to_xyzrpy()
    dist = jnp.linalg.norm(xyzrpy[:3])
    angles = jnp.abs(xyzrpy[3:])
    moved = (dist >= dist_threshold) | jnp.any(angles >= angle_threshold)
    return (db.count == 0) | moved


def update_poses(db: KeyframeDB, rot: jnp.ndarray, trans: jnp.ndarray) -> KeyframeDB:
    """Wholesale pose rewrite after a loop closure (correctPoses,
    backMapping.cpp:1287-1320)."""
    valid = db.valid()
    return db._replace(
        rot=jnp.where(valid[:, None, None], rot, db.rot),
        trans=jnp.where(valid[:, None], trans, db.trans),
    )


def extract_submap(
    db: KeyframeDB,
    query_trans: jnp.ndarray,
    query_time: jnp.ndarray,
    search_radius: float,
    recency_sec: float,
    max_nearby: int,
    corner_out_cap: int,
    surf_out_cap: int,
    corner_leaf: float,
    surf_leaf: float,
) -> Tuple[PaddedCloud, PaddedCloud]:
    """Assemble the surrounding submap (extractNearby + extractCloud,
    backMapping.cpp:575-663): keyframes within `search_radius` of the query
    OR within `recency_sec` of the query time; their feature clouds are
    transformed to world and voxel-downsampled.

    The reference additionally voxel-downsamples the *pose set* (2 m grid)
    before gathering; here the nearest `max_nearby` poses are taken instead
    — a fixed-size top-k that serves the same purpose (bounding submap
    size) without a dynamic-shape filter.
    """
    valid = db.valid()
    d2 = jnp.sum((db.trans - query_trans) ** 2, axis=-1)
    recent = (query_time - db.time) < recency_sec
    eligible = valid & ((d2 <= search_radius**2) | recent)
    # nearest max_nearby eligible keyframes
    max_nearby = min(max_nearby, db.capacity)
    score = jnp.where(eligible, d2, jnp.inf)
    _, sel = jax.lax.top_k(-score, max_nearby)  # [M]
    sel_ok = jnp.isfinite(score[sel])

    def gather(xyz_all, mask_all, out_cap, leaf):
        xyz = xyz_all[sel]  # [M, C, 3]
        mask = mask_all[sel] & sel_ok[:, None]
        rot = db.rot[sel]
        trans = db.trans[sel]
        world = jnp.einsum("mij,mnj->mni", rot, xyz) + trans[:, None, :]
        flat = PaddedCloud(world.reshape(-1, 3), mask.reshape(-1))
        return voxel_downsample(flat, leaf, out_cap)

    corners = gather(db.corner_xyz, db.corner_mask, corner_out_cap, corner_leaf)
    surfs = gather(db.surf_xyz, db.surf_mask, surf_out_cap, surf_leaf)
    return corners, surfs
