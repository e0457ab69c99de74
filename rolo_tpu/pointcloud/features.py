"""LOAM-style feature extraction over per-ring compacted range scans.

JAX re-design of FeatureExtraction
(/root/reference/src/featureExtraction.cpp:87-265). The reference sorts each
(ring, sector) span by smoothness and greedily picks corners with neighbor
suppression; here the greedy pick is 20 rounds of masked argmax over all
(ring, sector) pairs at once — identical semantics (argmax == next item of
the descending sort), fully vectorized.

Notes on fidelity:
  - Smoothness stencil, occlusion and parallel-beam marking match
    featureExtraction.cpp:87-150 exactly, computed per ring (the reference
    computes across ring boundaries in the flat array, but only interior
    points with a 5-point margin are ever selected, so behavior matches for
    all selectable points).
  - The reference's "surface" output is every non-corner point inside the
    sector spans (cloudLabel <= 0 at featureExtraction.cpp:241-253), then
    per-ring voxel-grid downsampled; reproduced here with a segment-mean
    voxel downsample keyed by (ring, voxel).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .cloud import PaddedCloud
from .projection import RingImage

_NUM_SECTORS = 6
_MAX_CORNERS_PER_SECTOR = 20


class FeatureClouds(NamedTuple):
    corners: PaddedCloud
    surfaces: PaddedCloud


def calculate_smoothness(rng: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """11-tap LOAM curvature (featureExtraction.cpp:87-110). rng [R, H]."""
    h = rng.shape[1]
    acc = -10.0 * rng
    for off in range(1, 6):
        acc = acc + jnp.roll(rng, off, axis=1) + jnp.roll(rng, -off, axis=1)
    # Only interior points (5-point margin) are meaningful.
    idx = jnp.arange(h)[None, :]
    interior = (idx >= 5) & (idx < count[:, None] - 5)
    return jnp.where(interior, acc * acc, 0.0)


def mark_occluded(rng: jnp.ndarray, col: jnp.ndarray, count: jnp.ndarray) -> jnp.ndarray:
    """Occluded + parallel-beam mask (featureExtraction.cpp:112-150).

    Returns picked [R, H] bool: True = excluded from feature selection.
    """
    h = rng.shape[1]
    idx = jnp.arange(h)[None, :]
    in_pair = (idx >= 5) & (idx < count[:, None] - 6)  # i range of the reference loop

    nxt = jnp.roll(rng, -1, axis=1)
    col_nxt = jnp.roll(col, -1, axis=1)
    col_diff_small = jnp.abs(col_nxt - col) < 10

    # depth1 - depth2 > 0.3: mark i-5..i ; depth2 - depth1 > 0.3: mark i+1..i+6
    occ_back = in_pair & col_diff_small & ((rng - nxt) > 0.3)
    occ_fwd = in_pair & col_diff_small & ((nxt - rng) > 0.3)

    picked = jnp.zeros_like(rng, dtype=bool)
    for off in range(0, 6):
        picked |= jnp.roll(occ_back, -off, axis=1)  # occ_back at i marks i-5..i
    for off in range(1, 7):
        picked |= jnp.roll(occ_fwd, off, axis=1)  # occ_fwd at i marks i+1..i+6

    prv = jnp.roll(rng, 1, axis=1)
    diff1 = jnp.abs(prv - rng)
    diff2 = jnp.abs(nxt - rng)
    parallel = in_pair & (diff1 > 0.02 * rng) & (diff2 > 0.02 * rng)
    return picked | parallel


def _sector_bounds(count: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-ring sector [sp, ep] spans (featureExtraction.cpp:173-174).

    start = 4, end = count - 6 in ring-local indices (cloudExtraction sets
    startRingIndex = base - 1 + 5, endRingIndex = base + count - 1 - 5).
    Returns (sp [R, 6], ep [R, 6]).
    """
    start = jnp.full_like(count, 4)
    end = count - 6
    j = jnp.arange(_NUM_SECTORS)[None, :]
    sp = (start[:, None] * (6 - j) + end[:, None] * j) // 6
    ep = (start[:, None] * (5 - j) + end[:, None] * (j + 1)) // 6 - 1
    return sp, ep


def _suppress_neighbors(picked: jnp.ndarray, sel_onehot: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """Mark +-5 neighbors of selected points, stopping at column gaps > 10
    (featureExtraction.cpp:196-210). sel_onehot [R, H] bool of fresh picks."""
    col_gap_fwd = jnp.abs(col - jnp.roll(col, 1, axis=1)) > 10  # gap between i-1 and i
    run_fwd = sel_onehot
    for _ in range(5):
        # the suppression wave reaches i+1 only if the column gap is small
        run_fwd = jnp.roll(run_fwd, 1, axis=1) & ~col_gap_fwd
        picked = picked | run_fwd
    run_bwd = sel_onehot
    col_gap_bwd = jnp.roll(col_gap_fwd, -1, axis=1)  # gap between i and i+1
    for _ in range(5):
        run_bwd = jnp.roll(run_bwd, -1, axis=1) & ~col_gap_bwd
        picked = picked | run_bwd
    return picked


def extract_features(
    ring: RingImage,
    edge_threshold: float,
    surf_threshold: float,
    surf_leaf_size: float,
    max_corners: int,
    max_surfs: int,
) -> FeatureClouds:
    """Full feature extraction for one scan. Returns padded corner/surface clouds."""
    r, h = ring.rng.shape
    smooth = calculate_smoothness(ring.rng, ring.count)
    picked = mark_occluded(ring.rng, ring.col, ring.count)
    picked |= ~ring.mask

    sp, ep = _sector_bounds(ring.count)  # [R, 6]
    idx = jnp.arange(h)[None, :]
    # sector id per point; -1 if outside all sector spans
    in_sector = (idx[:, :, None] >= sp[:, None, :]) & (idx[:, :, None] <= ep[:, None, :])  # [R,H,6]
    sector_id = jnp.where(jnp.any(in_sector, axis=2), jnp.argmax(in_sector, axis=2), -1)

    # --- corner picking: 20 rounds of per-(ring, sector) argmax ---
    corner = jnp.zeros((r, h), dtype=bool)

    def pick_round(state, _):
        picked, corner = state
        eligible = (~picked) & (smooth > edge_threshold) & (sector_id >= 0)
        value = jnp.where(eligible, smooth, -jnp.inf)
        sel = jnp.zeros((r, h), dtype=bool)
        for s in range(_NUM_SECTORS):
            vs = jnp.where(sector_id == s, value, -jnp.inf)
            best = jnp.argmax(vs, axis=1)  # [R]
            has = jnp.take_along_axis(vs, best[:, None], axis=1)[:, 0] > -jnp.inf
            sel_s = (jnp.arange(h)[None, :] == best[:, None]) & has[:, None]
            sel |= sel_s
        corner = corner | sel
        picked = picked | sel
        picked = _suppress_neighbors(picked, sel, ring.col)
        return (picked, corner), None

    (picked, corner), _ = jax.lax.scan(pick_round, (picked, corner), None, length=_MAX_CORNERS_PER_SECTOR)

    # --- surface: every in-sector non-corner point (cloudLabel <= 0) ---
    surf_mask = (sector_id >= 0) & (~corner) & ring.mask

    corners = _compact_select(ring.xyz, corner, max_corners)
    surfaces = voxel_downsample_rings(ring.xyz, surf_mask, surf_leaf_size, max_surfs)
    return FeatureClouds(corners, surfaces)


def _compact_select(xyz: jnp.ndarray, sel: jnp.ndarray, capacity: int) -> PaddedCloud:
    """Gather selected [R, H] points into a padded [capacity, 3] cloud."""
    flat_xyz = xyz.reshape(-1, 3)
    flat_sel = sel.reshape(-1)
    order = jnp.argsort(~flat_sel, stable=True)[:capacity]
    out = flat_xyz[order]
    mask = flat_sel[order]
    return PaddedCloud(jnp.where(mask[:, None], out, 0.0), mask)


def voxel_downsample_rings(
    xyz: jnp.ndarray, sel: jnp.ndarray, leaf: float, capacity: int
) -> PaddedCloud:
    """Per-ring voxel-grid centroid downsample (featureExtraction.cpp:255-264:
    the reference runs pcl::VoxelGrid per ring then concatenates — keyed here
    by (ring, voxel) in one pass)."""
    r, h = sel.shape
    ring_id = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[:, None], (r, h)).reshape(-1)
    return _voxel_downsample_impl(xyz.reshape(-1, 3), sel.reshape(-1), leaf, capacity, ring_id)


def voxel_downsample(cloud: PaddedCloud, leaf: float, capacity: int) -> PaddedCloud:
    """Whole-cloud voxel-grid centroid downsample (pcl::VoxelGrid analog)."""
    return _voxel_downsample_impl(cloud.xyz, cloud.mask, leaf, capacity, None)


def _voxel_downsample_impl(xyz, sel, leaf, capacity, ring_id):
    """Sort-by-hash + segment-mean voxel grid.

    int64 is unavailable (x64 disabled), so voxel cells are grouped by a
    mixed int32 hash; segment boundaries are detected by comparing the actual
    integer coordinates, so a hash collision can at worst split one voxel
    into two output points (probability ~1e-5), never corrupt a centroid.
    """
    from ..voxel.voxelmap import hash_coord

    coord = jnp.floor(xyz / leaf).astype(jnp.int32)
    h = hash_coord(coord, salt=ring_id)
    sort_key = jnp.where(sel, h, 0x7FFFFFFF)  # invalid sorts last

    order = jnp.argsort(sort_key)
    coord_s = coord[order]
    xyz_s = xyz[order]
    sel_s = sel[order]
    if ring_id is not None:
        ring_s = ring_id[order]

    same_as_prev = jnp.all(coord_s[1:] == coord_s[:-1], axis=1) & sel_s[1:] & sel_s[:-1]
    if ring_id is not None:
        same_as_prev &= ring_s[1:] == ring_s[:-1]
    new_seg = jnp.concatenate([jnp.ones((1,), bool), ~same_as_prev])
    seg_id = jnp.cumsum(new_seg) - 1  # valid segments get the lowest ids
    seg_id = jnp.where(sel_s, jnp.minimum(seg_id, capacity), capacity)

    sums = jnp.zeros((capacity + 1, 3), dtype=xyz.dtype).at[seg_id].add(xyz_s)
    cnts = jnp.zeros((capacity + 1,), dtype=jnp.float32).at[seg_id].add(sel_s.astype(jnp.float32))
    cnts = cnts[:capacity]
    centroids = sums[:capacity] / jnp.maximum(cnts, 1.0)[:, None]
    mask = cnts > 0
    return PaddedCloud(jnp.where(mask[:, None], centroids, 0.0), mask)
