"""Ground map: height queries, local plane fits, and patch extraction.

JAX re-design of the reference's GroundModel
(/root/reference/include/rolo/pose_solver.hpp:57-83,
/root/reference/src/prior_pose/pose_solver.cpp:120-378). The xy kd-tree
becomes a masked brute-force distance matrix (one matmul); the dynamic
radius searches become fixed-radius masked reductions. The ground cloud is
a PaddedCloud, typically the external "/voxel_map" ground mapping input
(launch/module_prior.launch:9).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.eig3 import eigh3
from ..pointcloud.cloud import PaddedCloud

# FitLocalSurface call-site constants (pose_solver.cpp:597-607, hardcoded
# at the ComputeResidualAndJacobian query site)
FIT_RADIUS = 0.6
FIT_OUTLIER_SIGMA = 3.0
FIT_MIN_POINTS = 15


class GroundMap(NamedTuple):
    """Masked ground cloud (GroundModel::UpdateFromCloud,
    pose_solver.cpp:120-146)."""

    xyz: jnp.ndarray  # [G, 3]
    mask: jnp.ndarray  # [G]

    @property
    def ready(self) -> jnp.ndarray:
        return jnp.any(self.mask)


def from_cloud(cloud: PaddedCloud) -> GroundMap:
    return GroundMap(cloud.xyz, cloud.mask)


def _xy_d2(gm: GroundMap, xy: jnp.ndarray) -> jnp.ndarray:
    d = gm.xyz[:, :2] - xy
    d2 = jnp.sum(d * d, axis=-1)
    return jnp.where(gm.mask, d2, jnp.inf)


def nearest_point_xy(gm: GroundMap, xy: jnp.ndarray) -> jnp.ndarray:
    """NearestPointXY (pose_solver.cpp:151-159): full 3D point whose xy is
    closest to the query; zeros when the map is empty."""
    d2 = _xy_d2(gm, xy)
    idx = jnp.argmin(d2)
    pt = gm.xyz[idx]
    return jnp.where(gm.ready, pt, jnp.zeros(3, gm.xyz.dtype))


def average_height_at(
    gm: GroundMap,
    xy: jnp.ndarray,
    radius: float,
    min_neighbors: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """AverageHeightAt (pose_solver.cpp:161-203): mean z of points within
    `radius` (xy) of the *nearest map point* to the query; falls back to the
    nearest point's z when too few neighbors. Returns (height, ok)."""
    d2 = _xy_d2(gm, xy)
    ni = jnp.argmin(d2)
    center = gm.xyz[ni, :2]
    nearest_z = gm.xyz[ni, 2]

    cd = gm.xyz[:, :2] - center
    in_r = gm.mask & (jnp.sum(cd * cd, axis=-1) <= radius * radius)
    n = jnp.sum(in_r)
    mean_z = jnp.sum(jnp.where(in_r, gm.xyz[:, 2], 0.0)) / jnp.maximum(n, 1)
    height = jnp.where(n >= min_neighbors, mean_z, nearest_z)
    return jnp.where(gm.ready, height, 0.0), gm.ready


def fit_local_surface(
    gm: GroundMap,
    xy: jnp.ndarray,
    radius: float = FIT_RADIUS,
    outlier_sigma: float = FIT_OUTLIER_SIGMA,
    min_points: int = FIT_MIN_POINTS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FitLocalSurface (pose_solver.cpp:205-261): neighbors within `radius`
    of the query xy, z-outlier rejection at mean +- sigma*std, PCA plane
    fit (FitPlane :326-353), evaluate z at the query xy. Returns
    (point [3], ok); callers fall back to nearest_point_xy on failure
    (the reference's call-site fallback, :604-607)."""
    d2 = _xy_d2(gm, xy)
    in_r = gm.mask & (d2 <= radius * radius)
    n = jnp.sum(in_r)

    w = in_r.astype(gm.xyz.dtype)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    z = gm.xyz[:, 2]
    mean_z = jnp.sum(w * z) / wsum
    std_z = jnp.sqrt(jnp.sum(w * (z - mean_z) ** 2) / wsum)
    inlier = in_r & (jnp.abs(z - mean_z) <= outlier_sigma * std_z)
    n_in = jnp.sum(inlier)

    wi = inlier.astype(gm.xyz.dtype)
    wisum = jnp.maximum(jnp.sum(wi), 1.0)
    centroid = jnp.einsum("n,ni->i", wi, gm.xyz) / wisum
    centered = gm.xyz - centroid
    cov = jnp.einsum("n,ni,nj->ij", wi, centered, centered)
    _, vecs = eigh3(cov)  # closed form (ops/eig3.py)
    normal = vecs[:, 0]  # smallest eigenvalue
    d = -jnp.dot(normal, centroid)
    c = normal[2]
    c_ok = jnp.abs(c) >= 1e-6
    z_fit = -(normal[0] * xy[0] + normal[1] * xy[1] + d) / jnp.where(c_ok, c, 1.0)
    ok = gm.ready & (n >= min_points) & (n_in >= min_points) & c_ok
    point = jnp.array([xy[0], xy[1], z_fit], gm.xyz.dtype)
    return jnp.where(ok, point, jnp.zeros(3, gm.xyz.dtype)), ok


def contact_point(gm: GroundMap, xy: jnp.ndarray) -> jnp.ndarray:
    """Plane-fit ground point with nearest-point fallback — the exact
    query sequence of ComputeResidualAndJacobian (pose_solver.cpp:597-608)."""
    fitted, ok = fit_local_surface(gm, xy)
    nearest = nearest_point_xy(gm, xy)
    return jnp.where(ok, fitted, nearest)


def extract_patch(gm: GroundMap, xy: jnp.ndarray, patch_size: float, capacity: int) -> PaddedCloud:
    """ExtractPatch (pose_solver.cpp:263-295): axis-aligned crop of
    half-width patch_size/2 around xy, compacted into a fixed-capacity
    cloud (points beyond capacity are dropped)."""
    half = 0.5 * patch_size
    inside = (
        gm.mask
        & (jnp.abs(gm.xyz[:, 0] - xy[0]) <= half)
        & (jnp.abs(gm.xyz[:, 1] - xy[1]) <= half)
    )
    order = jnp.argsort(~inside, stable=True)[:capacity]
    return PaddedCloud(gm.xyz[order], inside[order])


class LiveGroundMap(NamedTuple):
    """Rolling self-built ground map in the ESTIMATE's world frame — the
    in-repo analog of the external `point_seg ground_mapping` node's
    /voxel_map (launch/module_prior.launch:9; consumed by
    backMapping::groundMapHandler, backMapping.cpp:403-417, and
    prior_pose_node). Ground points segmented from each scan
    (pointcloud/ground_seg.py) are transformed by the current mapped pose
    and written slot-wise into a fixed ring buffer: every frame stays
    consistent with the drifting estimate, which is what lets the prior
    patch ICP measure drift instead of GT-vs-estimate mismatch."""

    xyz: jnp.ndarray  # [S * C, 3] world frame
    mask: jnp.ndarray  # [S * C]
    cursor: jnp.ndarray  # [] int32 next slot

    @property
    def ready(self) -> jnp.ndarray:
        return jnp.any(self.mask)

    def as_ground_map(self) -> GroundMap:
        return GroundMap(self.xyz, self.mask)


def init_live_ground(n_slots: int, slot_capacity: int, dtype=jnp.float32) -> LiveGroundMap:
    return LiveGroundMap(
        xyz=jnp.zeros((n_slots * slot_capacity, 3), dtype),
        mask=jnp.zeros((n_slots * slot_capacity,), bool),
        cursor=jnp.asarray(0, jnp.int32),
    )


def update_live_ground(
    gm: LiveGroundMap,
    ground_sensor: PaddedCloud,
    rot: jnp.ndarray,
    trans: jnp.ndarray,
    slot_capacity: int,
    leaf: float = 0.4,
) -> LiveGroundMap:
    """Insert one scan's segmented ground (sensor frame) at pose (rot,
    trans): voxel-downsample to the slot capacity, transform to world,
    overwrite the oldest slot (ring buffer)."""
    from ..pointcloud.features import voxel_downsample

    ds = voxel_downsample(ground_sensor, leaf, slot_capacity)
    world = ds.xyz @ rot.T + trans
    world = jnp.where(ds.mask[:, None], world, 0.0)
    n_slots = gm.xyz.shape[0] // slot_capacity
    slot = gm.cursor % n_slots
    start = slot * slot_capacity
    xyz = jax.lax.dynamic_update_slice(gm.xyz, world, (start, jnp.asarray(0, start.dtype)))
    mask = jax.lax.dynamic_update_slice(gm.mask, ds.mask, (start,))
    return LiveGroundMap(xyz=xyz, mask=mask, cursor=gm.cursor + 1)
