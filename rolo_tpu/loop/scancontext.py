"""Scan Context global place-recognition descriptors, in fixed shapes.

Re-design of the vendored SCManager
(/root/reference/include/scancontext/Scancontext.h:58-114,
/root/reference/src/scancontext/Scancontext.cpp):

  - descriptor: 20 rings x 60 sectors max-z polar image
    (makeScancontext, Scancontext.cpp:151-195) -> a masked scatter-max,
  - ring key: rowwise mean (makeRingkeyFromScancontext :198-211) -> the
    rotation-invariant retrieval key; the reference's nanoflann kd-tree
    (rebuilt every 10 queries) becomes a dense distance matrix + top-k,
    which is exact and needs no rebuild cadence,
  - sector key: colwise mean (makeSectorkeyFromScancontext :214-227) for
    fast yaw alignment via exhaustive circular shift
    (fastAlignUsingVkey :91-111),
  - candidate refinement over a +-(search_ratio/2) shift window with the
    mean column cosine distance (distanceBtnScanContext :114-148,
    distDirectSC :67-88).

Everything is fixed-capacity and jit-compatible; the database is a pytree
(checkpointable) and detection is one fused program instead of a kd-tree +
per-candidate loops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import LoopConfig


def make_descriptor(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    num_ring: int = 20,
    num_sector: int = 60,
    max_radius: float = 80.0,
    lidar_height: float = 2.0,
) -> jnp.ndarray:
    """Polar max-z descriptor [num_ring, num_sector]
    (makeScancontext, Scancontext.cpp:151-195).

    Bins follow the reference exactly: ring = clamp(ceil(r / R_max * NR),
    1, NR), sector = clamp(ceil(theta_deg / 360 * NS), 1, NS); z is lifted
    by `lidar_height` so ground points stay positive; empty bins read 0.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2] + lidar_height
    azim_range = jnp.sqrt(x * x + y * y)
    # xy2theta (Scancontext.cpp:30-52): atan2 mapped to [0, 360) degrees
    theta = jnp.degrees(jnp.arctan2(y, x))
    theta = jnp.where(theta < 0, theta + 360.0, theta)

    ring = jnp.clip(jnp.ceil(azim_range / max_radius * num_ring), 1, num_ring) - 1
    sector = jnp.clip(jnp.ceil(theta / 360.0 * num_sector), 1, num_sector) - 1
    valid = mask & (azim_range <= max_radius)

    flat = ring.astype(jnp.int32) * num_sector + sector.astype(jnp.int32)
    n_bins = num_ring * num_sector
    # Scatter-free bin max (exact, and free of a 32k-element scatter-max):
    # lex-sort by
    # (bin, -z) so each bin's run starts at its max, then binary-search the
    # run start per bin. Invalid points sort into a sentinel bin past the
    # end.
    flat = jnp.where(valid, flat, n_bins)
    flat_sorted, neg_z_sorted = jax.lax.sort((flat, -z), num_keys=2)
    pos = jnp.searchsorted(flat_sorted, jnp.arange(n_bins, dtype=flat.dtype))
    pos = jnp.clip(pos, 0, flat.shape[0] - 1)
    hit = flat_sorted[pos] == jnp.arange(n_bins, dtype=flat.dtype)
    desc = jnp.where(hit, -neg_z_sorted[pos], 0.0)  # NO_POINT -> 0 (:186-190)
    return desc.reshape(num_ring, num_sector)


def ring_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Rowwise mean [..., R] (makeRingkeyFromScancontext :198-211)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc: jnp.ndarray) -> jnp.ndarray:
    """Colwise mean [..., S] (makeSectorkeyFromScancontext :214-227)."""
    return jnp.mean(desc, axis=-2)


class ScanContextDB(NamedTuple):
    """Fixed-capacity descriptor store (polarcontexts_ + key vectors,
    Scancontext.cpp:238-250)."""

    desc: jnp.ndarray  # [K, R, S]
    rkey: jnp.ndarray  # [K, R]
    skey: jnp.ndarray  # [K, S]
    count: jnp.ndarray  # [] int32

    @property
    def capacity(self) -> int:
        return self.desc.shape[0]


def init_db(capacity: int, num_ring: int = 20, num_sector: int = 60, dtype=jnp.float32) -> ScanContextDB:
    return ScanContextDB(
        desc=jnp.zeros((capacity, num_ring, num_sector), dtype),
        rkey=jnp.zeros((capacity, num_ring), dtype),
        skey=jnp.zeros((capacity, num_sector), dtype),
        count=jnp.asarray(0, jnp.int32),
    )


def add_descriptor(db: ScanContextDB, desc: jnp.ndarray) -> ScanContextDB:
    """makeAndSaveScancontextAndKeys (Scancontext.cpp:238-250). Drops
    silently at capacity."""
    idx = jnp.minimum(db.count, db.capacity - 1)
    ok = db.count < db.capacity

    def upd(arr, val):
        return jnp.where(ok, arr.at[idx].set(val), arr)

    return ScanContextDB(
        desc=upd(db.desc, desc),
        rkey=upd(db.rkey, ring_key(desc)),
        skey=upd(db.skey, sector_key(desc)),
        count=jnp.where(ok, db.count + 1, db.count),
    )


class LoopDetection(NamedTuple):
    index: jnp.ndarray  # [] int32 matched keyframe (valid iff found)
    yaw_rad: jnp.ndarray  # [] estimated yaw offset of the match
    distance: jnp.ndarray  # [] best scan-context distance
    found: jnp.ndarray  # [] bool


def _sc_distance(query: jnp.ndarray, cand_shifted: jnp.ndarray) -> jnp.ndarray:
    """Mean column cosine distance (distDirectSC, Scancontext.cpp:67-88).

    query [R, S], cand_shifted [..., R, S] -> [...]. Columns where either
    side has zero norm are excluded from the mean.
    """
    qn = jnp.linalg.norm(query, axis=-2)  # [S]
    cn = jnp.linalg.norm(cand_shifted, axis=-2)  # [..., S]
    dot = jnp.einsum("rs,...rs->...s", query, cand_shifted)
    eff = (qn > 0) & (cn > 0)
    sim = jnp.where(eff, dot / jnp.maximum(qn * cn, 1e-12), 0.0)
    n_eff = jnp.maximum(jnp.sum(eff, axis=-1), 1)
    return 1.0 - jnp.sum(sim, axis=-1) / n_eff


@partial(jax.jit, static_argnames=("cfg",))
def detect_loop(db: ScanContextDB, cfg: LoopConfig = LoopConfig()) -> LoopDetection:
    """detectLoopClosureID (Scancontext.cpp:253-344) for the most recent
    descriptor: ring-key top-k candidates (excluding the last
    `sc_num_exclude_recent`), sector-key circshift alignment, refined
    cosine distance over the +-(search_ratio/2 * S) shift window.
    """
    k_cap = db.capacity
    num_s = db.desc.shape[-1]
    cur = jnp.maximum(db.count - 1, 0)
    query = db.desc[cur]
    q_rkey = db.rkey[cur]
    q_skey = db.skey[cur]

    eligible = jnp.arange(k_cap) < (db.count - cfg.sc_num_exclude_recent)
    d_rk = jnp.sum((db.rkey - q_rkey) ** 2, axis=-1)
    d_rk = jnp.where(eligible, d_rk, jnp.inf)
    _, cand = jax.lax.top_k(-d_rk, cfg.sc_num_candidates)  # [C]
    cand_ok = jnp.isfinite(d_rk[cand])

    # circshift(x, s)[c] = x[(c - s) mod S]  (Scancontext.cpp circshift:
    # shifts columns right). Gather matrix for all S shifts at once.
    cols = jnp.arange(num_s)
    shift_idx = (cols[None, :] - cols[:, None]) % num_s  # [S_shift, S_col]

    cand_skey = db.skey[cand]  # [C, S]
    skey_shifted = cand_skey[:, shift_idx]  # [C, S_shift, S]
    vkey_diff = jnp.linalg.norm(skey_shifted - q_skey[None, None, :], axis=-1)
    best_shift = jnp.argmin(vkey_diff, axis=-1)  # [C] (fastAlignUsingVkey)

    # refined search window: +- round(0.5 * ratio * S) around best_shift
    radius = round(0.5 * cfg.sc_search_ratio * num_s)
    offsets = jnp.arange(-radius, radius + 1)
    shifts = (best_shift[:, None] + offsets[None, :]) % num_s  # [C, NS]

    cand_desc = db.desc[cand]  # [C, R, S]
    gather = (cols[None, None, :] - shifts[:, :, None]) % num_s  # [C, NS, S]
    desc_shifted = jnp.take_along_axis(
        cand_desc[:, None, :, :], gather[:, :, None, :], axis=-1
    )  # [C, NS, R, S]
    dist = _sc_distance(query, desc_shifted)  # [C, NS]
    dist = jnp.where(cand_ok[:, None], dist, jnp.inf)

    flat = jnp.argmin(dist)
    ci, si = jnp.unravel_index(flat, dist.shape)
    min_dist = dist[ci, si]
    nn_idx = cand[ci]
    nn_shift = shifts[ci, si]

    enough_history = db.count >= cfg.sc_num_exclude_recent + 1
    found = enough_history & (min_dist < cfg.sc_dist_threshold)
    yaw = nn_shift.astype(query.dtype) * (2.0 * jnp.pi / num_s)
    return LoopDetection(
        index=nn_idx.astype(jnp.int32),
        yaw_rad=yaw,
        distance=jnp.where(enough_history, min_dist, jnp.inf),
        found=found,
    )
