"""Exact packed voxel keys and the keyed reductions over them.

The reference binds each source point to its voxel with an unordered_map
lookup (update_correspondences, rot_vgicp_impl.hpp:172-222) and builds the
map by pointer-chasing inserts (create_voxelmap, vmp_voxel.hpp:167-197).
Here a voxel's bin packs exactly into one int32 (pack_polar/pack_uniform),
so key equality is exact bin equality with zero collisions. A voxel table
is an ascending array of packs, and both operations key into it by binary
search:

- voxel lookup: query pack -> leftmost table slot holding it, then a
  gather of that slot's stat planes (search_slots);
- voxel build: per-point stat planes summed into the slot of the point's
  pack (segment_sums).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Packed-coordinate layout (exact, collision-free for in-range bins):
#   polar:   theta[7b] << 24 | phi[6b] << 18 | r[18b]
#   uniform: (x+512)[10b] << 20 | (y+512)[10b] << 10 | (z+512)[10b]
# INVALID never collides with any packed value produced from real bins.
# Plain Python int, NOT jnp.int32: a module-level device constant would
# initialize the JAX backend at import time, which breaks
# jax.distributed.initialize for any process that imports rolo_tpu before
# calling it (parallel/mesh.distributed_init).
INVALID_PACK = 0x7FFFFFFF


def pack_polar(coord: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] int32 (theta, phi, r) bins -> packed int32. Bins outside
    the representable range map to INVALID (no false matches)."""
    t, p, r = coord[..., 0], coord[..., 1], coord[..., 2]
    ok = (t >= 0) & (t < 128) & (p >= 0) & (p < 64) & (r >= 0) & (r < (1 << 18))
    packed = (t << 24) | (p << 18) | r
    return jnp.where(ok, packed, INVALID_PACK)


def unpack_polar(pack: jnp.ndarray) -> jnp.ndarray:
    """Inverse of pack_polar for valid packs -> [..., 3] int32."""
    t = (pack >> 24) & 0x7F
    p = (pack >> 18) & 0x3F
    r = pack & 0x3FFFF
    return jnp.stack([t, p, r], axis=-1)


def pack_uniform(coord: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] int32 cartesian bins -> packed int32 (valid |bin| < 512)."""
    c = coord + 512
    ok = jnp.all((c >= 0) & (c < 1024), axis=-1)
    packed = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    return jnp.where(ok, packed, INVALID_PACK)


def unpack_uniform(pack: jnp.ndarray) -> jnp.ndarray:
    """Inverse of pack_uniform for valid packs -> [..., 3] int32."""
    x = ((pack >> 20) & 0x3FF) - 512
    y = ((pack >> 10) & 0x3FF) - 512
    z = (pack & 0x3FF) - 512
    return jnp.stack([x, y, z], axis=-1)


def search_slots(table: jnp.ndarray, keys: jnp.ndarray) -> jnp.ndarray:
    """Leftmost slot of each key in the ascending `table` -> [M] int32
    (clipped into range; callers check `table[slot] == key`)."""
    slot = jnp.searchsorted(table, keys, method="scan_unrolled")
    return jnp.clip(slot, 0, table.shape[0] - 1).astype(jnp.int32)


def segment_sums(values: jnp.ndarray, keys: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """Per-slot sums of values [S, N] whose key lands on that slot of the
    ascending `table` [V] (the leftmost slot holding the key); keys absent
    from the table drop out -> [S, V]."""
    slot = search_slots(table, keys)
    slot = jnp.where(table[slot] == keys, slot, table.shape[0])
    return jax.ops.segment_sum(values.T, slot, num_segments=table.shape[0]).T
