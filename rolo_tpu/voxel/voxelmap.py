"""Voxel maps over fixed-slot arrays: the fixed-shape replacement for the
reference's pointer-based spatial hash
(/root/reference/include/rot_gicp/gicp/vmp_voxel.hpp:157-243).

Design: a voxel map is a sorted array of (packed-bin, stat planes) rows.

  1. pack each point's bin into one int32 (exact, ops/voxel_join.py),
  2. sort the packs; runs of equal pack are voxels,
  3. unique packs -> table slots via one vectorized binary search,
  4. per-voxel sums (count, position, covariance) keyed by pack.

Lookups key the other direction: query pack -> table row. Stats live in
the SoA layout [S, V], one plane per statistic.

Supports both coordinate systems of the reference:
  - POLAR (theta, phi, r) bins — the "spherical alignment" structure used by
    rot-GICP (vmp_voxel.hpp:208-224),
  - UNIFORM cartesian bins (vmp_voxel.hpp:199-206).

Per-voxel statistics mirror AdditiveVmfVoxel (vmp_voxel.hpp:87-109):
num_points, mean position (mean_dir), mean of member covariances, and the
von-Mises-Fisher concentration kappa from the resultant length r_bar.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..ops import sym3
from ..ops.voxel_join import (
    INVALID_PACK,
    pack_polar,
    pack_uniform,
    search_slots,
    segment_sums,
    unpack_polar,
    unpack_uniform,
)


def polar_coord(xyz: jnp.ndarray, polar_res: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] point -> [..., 3] int32 (theta, phi, r) bin (vmp_voxel.hpp:208-211)."""
    t, p, r = polar_bins(xyz[..., 0], xyz[..., 1], xyz[..., 2], polar_res)
    return jnp.stack([t, p, r], axis=-1)


def polar_bins(x, y, z, polar_res):
    """Componentwise polar binning: (x, y, z) arrays -> (theta, phi, r)
    int32 bin arrays of the same shape (SoA twin of polar_coord)."""
    r = jnp.sqrt(x * x + y * y + z * z)
    theta = jnp.arctan2(y, x) + math.pi
    phi = jnp.arccos(jnp.clip(z / jnp.maximum(r, 1e-12), -1.0, 1.0))
    tb = jnp.floor(theta / polar_res[0]).astype(jnp.int32)
    pb = jnp.floor(phi / polar_res[1]).astype(jnp.int32)
    rb = jnp.floor(r / polar_res[2]).astype(jnp.int32)
    return tb, pb, rb


def polar_origin(coord: jnp.ndarray, polar_res: jnp.ndarray) -> jnp.ndarray:
    """Bin center -> cartesian point (vmp_voxel.hpp:213-224)."""
    polar = (coord.astype(jnp.float32) + 0.5) * polar_res
    theta = polar[..., 0] - math.pi
    phi = polar[..., 1]
    r = polar[..., 2]
    sin_phi = jnp.sin(phi)
    return jnp.stack(
        [r * sin_phi * jnp.cos(theta), r * sin_phi * jnp.sin(theta), r * jnp.cos(phi)],
        axis=-1,
    )


def uniform_coord(xyz: jnp.ndarray, resolution: float) -> jnp.ndarray:
    """Cartesian bin (vmp_voxel.hpp:199-201: floor(x/res - 0.5))."""
    return jnp.floor(xyz / resolution - 0.5).astype(jnp.int32)


def uniform_bins(x, y, z, resolution: float):
    """Componentwise uniform binning (SoA twin of uniform_coord)."""
    def f(a):
        return jnp.floor(a / resolution - 0.5).astype(jnp.int32)

    return f(x), f(y), f(z)


def hash_coord(coord: jnp.ndarray, salt: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """[..., 3] int32 -> int32 hash in [0, 2^30) (Murmur3-style finalizer).

    Not used by the voxel map itself anymore (bins pack exactly into one
    int32); kept for coarse grouping where coordinates exceed the packed
    range (pointcloud.features voxel downsample)."""
    c = coord.astype(jnp.uint32)
    h = (
        c[..., 0] * jnp.uint32(0x9E3779B1)
        + c[..., 1] * jnp.uint32(0x85EBCA77)
        + c[..., 2] * jnp.uint32(0xC2B2AE3D)
    )
    if salt is not None:
        h = h + salt.astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return (h >> jnp.uint32(2)).astype(jnp.int32)


class VoxelMap(NamedTuple):
    """Sorted fixed-capacity voxel table, SoA layout.

    pack [V] int32 sorted ascending, the exact packed bin per slot
    (INVALID_PACK for empty slots; at full capacity, duplicate slots
    repeat their run-start's pack with `valid`=False and zeroed stats —
    see build_voxel_map's fast path); stats [10, V] join-table planes
    (num, mean x/y/z, cov6) with zeroed invalid columns; num_points [V];
    mean [3, V]; cov6 [6, V]; kappa [V]; valid [V] bool; polar flag.
    """

    pack: jnp.ndarray
    stats: jnp.ndarray
    num_points: jnp.ndarray
    mean: jnp.ndarray
    cov6: jnp.ndarray
    kappa: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.pack.shape[0]

    def coord(self, polar: bool) -> jnp.ndarray:
        """[V, 3] integer bin coordinates recovered from the packs."""
        return unpack_polar(self.pack) if polar else unpack_uniform(self.pack)


def _kappa_from_rbar(r_bar: jnp.ndarray) -> jnp.ndarray:
    """vMF concentration approximation (vmp_voxel.hpp:104-106)."""
    series = 3.0 * r_bar * (1.0 + 0.6 * r_bar**2 + (99.0 / 175.0) * r_bar**4)
    exact = r_bar * (3.0 - r_bar**2) / jnp.maximum(1.0 - r_bar**2, 1e-9)
    k = jnp.where(r_bar < 0.6, series, exact)
    return jnp.where(r_bar < 1e-8, 0.0, k)


def build_voxel_map(
    xyz: jnp.ndarray,
    cov6: jnp.ndarray,
    mask: jnp.ndarray,
    capacity: int,
    polar_res: Optional[jnp.ndarray] = None,
    resolution: float = 1.0,
) -> VoxelMap:
    """Build a voxel map from a padded cloud (create_voxelmap,
    vmp_voxel.hpp:167-197). polar_res given -> POLAR bins, else UNIFORM.

    xyz [N, 3]; cov6 [6, N] (sym3 planes); mask [N].

    The table can never hold more voxels than input points, so the slot
    count is clamped to N (rounded up to a lane tile) — a 2x saving on
    every downstream join when callers size `capacity` generously.
    """
    capacity = min(capacity, ((xyz.shape[0] + 127) // 128) * 128)
    if polar_res is not None:
        coord = polar_coord(xyz, polar_res)
        pack = pack_polar(coord)
    else:
        coord = uniform_coord(xyz, resolution)
        pack = pack_uniform(coord)
    pack = jnp.where(mask, pack, INVALID_PACK)

    sp = jnp.sort(pack)
    is_valid = sp != INVALID_PACK
    new_seg = is_valid & jnp.concatenate(
        [jnp.ones((1,), bool), sp[1:] != sp[:-1]]
    )
    if capacity >= sp.shape[0]:
        # Fast path (production shapes: capacity >= N): keep the sorted
        # packs WITH duplicates as the table and mark only run starts
        # valid, which saves compacting unique packs into slots.
        # Correctness is unchanged downstream:
        #   - the binary search of lookup_join and segment_sums returns
        #     the LEFTMOST match, which in a sorted array is precisely the
        #     run start (the valid slot); duplicate slots get no sums and
        #     are marked invalid;
        #   - INVALID_PACK (int32 max) sorts last, so the table stays
        #     ascending for the binary search.
        table_pack = sp
        valid = new_seg
    else:
        # Truncating path (capacity < N): unique packs -> compact slots:
        # binary-search the v-th run start. Keeps the smallest `capacity`
        # packed bins; only used by callers that deliberately shrink the
        # table (tests, memory-tight submaps).
        n_seg = jnp.sum(new_seg)
        seg_id = jnp.where(is_valid, jnp.cumsum(new_seg) - 1, jnp.int32(2**30))
        slot = jnp.arange(capacity, dtype=jnp.int32)
        pos = jnp.clip(jnp.searchsorted(seg_id, slot), 0, sp.shape[0] - 1)
        valid = slot < n_seg
        table_pack = jnp.where(valid, sp[pos], INVALID_PACK)

    # per-voxel sums (segment-reduce keyed by pack)
    w = mask.astype(xyz.dtype)
    data = jnp.concatenate(
        [w[None, :], xyz.T * w[None, :], cov6 * w[None, :]], axis=0
    )  # [10, N]
    sums = segment_sums(data, pack, table_pack)  # [10, V]

    num = sums[0]
    denom = jnp.maximum(num, 1.0)
    mean = sums[1:4] / denom[None, :]
    cov = sums[4:10] / denom[None, :]
    r_bar = jnp.sqrt(jnp.sum(sums[1:4] ** 2, axis=0)) / denom
    # NOTE(reference parity): AdditiveVmfVoxel::append recomputes
    # r_bar = |running mean_dir sum| / n each append and finalize() divides
    # once more by n; the value kept is |sum p| / n (positions, not unit
    # dirs). kappa is computed from that (vmp_voxel.hpp:97,104-106). kappa
    # is not used by any solver path (weight is sqrt(num_points),
    # rot_vgicp_impl.hpp:258) but is exposed for parity.
    kappa = jnp.where(valid, _kappa_from_rbar(r_bar), 0.0)

    stats = jnp.concatenate([num[None, :], mean, cov], axis=0)
    stats = jnp.where(valid[None, :], stats, 0.0)
    return VoxelMap(
        pack=table_pack,
        stats=stats,
        num_points=jnp.where(valid, num, 0.0),
        mean=jnp.where(valid[None, :], mean, 0.0),
        cov6=jnp.where(valid[None, :], cov, 0.0),
        kappa=kappa,
        valid=valid,
    )


def lookup(
    vmap: VoxelMap, coord: jnp.ndarray, polar: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Reference-shaped per-query lookup (lookup_voxel,
    vmp_voxel.hpp:226-233): an AoS wrapper over lookup_join.

    coord [N, 3] int32 -> (found [N], num [N], mean [N, 3], cov [N, 3, 3]).
    """
    q = pack_polar(coord) if polar else pack_uniform(coord)
    found, num, mean, cov6 = lookup_join(vmap, q)
    return found, num, mean.T, sym3.to_mat(cov6)


def lookup_join(
    vmap: VoxelMap, pack: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Packed-key lookup — the production binding path: binary search for
    the leftmost table slot holding each query pack (the run start, i.e.
    the valid slot, in a fast-path table), then a gather of its stats.

    pack [M] int32 queries -> SoA results:
    (found [M], num [M], mean [3, M], cov6 [6, M]).
    """
    idx = search_slots(vmap.pack, pack)
    found = (vmap.pack[idx] == pack) & vmap.valid[idx]
    out = jnp.where(found[None, :], vmap.stats[:, idx], 0.0)  # [10, M]
    return found, out[0], out[1:4], out[4:10]
