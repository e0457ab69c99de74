"""The production moment selector of estimate_cov6 (k-NN membership radius
+ one moment matmul, voxel/knn.py) against an f64 oracle with the same
semantics: every candidate within the k-th nearest distance (ties
included) is a member, covariance = sum of mean-centred outer products / k.

The bounds come from what the moment formula gives in f32 at lidar
coordinates (E[xx] - mu mu^T cancels ~2.5e3-sized terms down to
~1e-2-sized covariances): median ~1e-3 relative, worst ~1e-2. A
precision downgrade of the moment matmul (a 10-bit-mantissa product)
misses these by orders of magnitude.
"""

import numpy as np
import jax.numpy as jnp

from rolo_tpu.voxel.knn import estimate_cov6

IDENT6 = np.array([1.0, 0, 0, 1.0, 0, 1.0])


def _oracle(xyz, mask, cand, cand_mask, k):
    """f64 covariances [6, Q] over the d2 <= r_k membership; masked
    queries get the identity, as estimate_cov6 returns."""
    q = np.where(mask[:, None], xyz, 0.0).astype(np.float64)
    c = np.where(cand_mask[:, None], cand, 0.0).astype(np.float64)
    d2 = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    d2[:, ~cand_mask] = np.inf
    out = np.tile(IDENT6[:, None], (1, len(q)))
    for i in np.flatnonzero(mask):
        valid = np.isfinite(d2[i])
        rk = np.sort(d2[i][valid])[min(k, valid.sum()) - 1]
        nb = c[(d2[i] <= rk) & valid]
        cen = nb - nb.mean(axis=0)
        cov = cen.T @ cen / k
        out[:, i] = cov[[0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    return out


def _run(xyz, mask, cand, cand_mask, k):
    kw = {}
    if cand is not xyz:
        kw = dict(cand_xyz=jnp.asarray(cand), cand_mask=jnp.asarray(cand_mask))
    return np.asarray(estimate_cov6(jnp.asarray(xyz), jnp.asarray(mask), k=k,
                                    method="none", selector="moment", **kw))


def _rel(got, want, mask):
    """Per-query max-entry error relative to the query's largest entry."""
    r = np.abs(got - want).max(axis=0) / (np.abs(want).max(axis=0) + 1e-12)
    return r[mask]


def _lidar_cloud(rng, n, spread=0.5, lo=20.0, hi=50.0):
    return (rng.normal(size=(n, 3)) * spread + rng.uniform(lo, hi, size=(n, 1))).astype(
        np.float32
    )


def test_matches_oracle_lidar_scale():
    """At lidar ranges (the cancellation regime of the moment formula)."""
    rng = np.random.default_rng(0)
    n, k = 512, 8
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    rel = _rel(_run(xyz, mask, xyz, mask, k), _oracle(xyz, mask, xyz, mask, k), mask)
    assert np.median(rel) < 5e-3
    assert rel.max() < 3e-2


def test_nan_padding_and_masked_candidates():
    """NaN-padded masked slots must not poison any query's membership."""
    rng = np.random.default_rng(1)
    n, k = 384, 6
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    mask[300:] = False
    xyz_dirty = xyz.copy()
    xyz_dirty[~mask] = np.nan
    got = _run(xyz_dirty, mask, xyz_dirty, mask, k)
    assert np.isfinite(got).all()
    rel = _rel(got, _oracle(xyz, mask, xyz, mask, k), mask)
    assert np.median(rel) < 5e-3
    assert rel.max() < 3e-2
    # masked queries get the identity
    np.testing.assert_array_equal(got[:, ~mask], np.tile(IDENT6[:, None], (1, (~mask).sum())))


def test_fewer_than_k_valid_candidates():
    """Starved queries: fewer valid candidates than k. Invalid candidates
    sit at infinite distance and carry zero moments, so the neighbourhood
    is exactly the valid set (scaled by the reference's 1/k)."""
    rng = np.random.default_rng(2)
    n, k = 256, 20
    xyz = _lidar_cloud(rng, n)
    mask = np.zeros(n, bool)
    mask[:8] = True  # only 8 valid, k=20
    rel = _rel(_run(xyz, mask, xyz, mask, k), _oracle(xyz, mask, xyz, mask, k), mask)
    assert rel.max() < 1e-4


def test_split3_not_elided_moments_are_f32_accurate():
    """Second moments at coordinate scale ~50 m need a full f32 product:
    a 10-bit-mantissa matmul (TF32, or one bf16 pass) quantizes the
    E[xx] table by ~1e-3 relative, i.e. by more than the covariances
    themselves, and fails this bound by orders of magnitude."""
    rng = np.random.default_rng(3)
    n, k = 256, 8
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    rel = _rel(_run(xyz, mask, xyz, mask, k), _oracle(xyz, mask, xyz, mask, k), mask)
    assert rel.max() < 2e-2


def test_query_set_differs_from_candidate_set():
    """SPMD shape: local queries against an all-gathered candidate set."""
    rng = np.random.default_rng(4)
    nq, nc, k = 128, 640, 10
    cand = _lidar_cloud(rng, nc)
    cand_mask = rng.random(nc) < 0.9
    xyz = cand[:nq].copy()
    mask = cand_mask[:nq].copy()
    rel = _rel(_run(xyz, mask, cand, cand_mask, k), _oracle(xyz, mask, cand, cand_mask, k), mask)
    assert np.median(rel) < 5e-3
    assert rel.max() < 3e-2
