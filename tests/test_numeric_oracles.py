"""Numeric oracles for the main path's primitives: each against an f64 or
exact reference, at the sizes the CPU suite affords. chip_smoke.py's
kernels phase runs the same comparisons at production widths on the GPU.

  - voxel/knn.py        moment selector vs the exact top-k selector
  - ops/linalg.py       adjugate 3x3 / unrolled-Cholesky 6x6 solve_psd
  - voxel/voxelmap.py   full-capacity duplicate-slot fast path vs the
                        truncating path, and per-voxel stats vs numpy
  - ops/voxel_join.py   keyed segment reduce vs f64
  - ops/eig3.py         closed-form symmetric 3x3 eigendecomposition
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rolo_tpu.ops.eig3 import eigh3
from rolo_tpu.ops.linalg import solve_psd
from rolo_tpu.ops.voxel_join import pack_uniform, segment_sums
from rolo_tpu.voxel.knn import estimate_cov6
from rolo_tpu.voxel.voxelmap import build_voxel_map, lookup, uniform_coord


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _lidar_cloud(rng, n, spread=0.5, lo=20.0, hi=50.0):
    return (rng.normal(size=(n, 3)) * spread + rng.uniform(lo, hi, size=(n, 1))).astype(
        np.float32
    )


# ------------------------------------------------------- moment selector


def test_moment_selector_matches_exact_selector(rng):
    """The production covariance path (moment selector) vs the exact top-k
    gather selector, pre-regularization."""
    n, k = 4096, 20
    xyz = _lidar_cloud(rng, n)
    mask = rng.random(n) < 0.85
    c_mom = np.asarray(estimate_cov6(jnp.asarray(xyz), jnp.asarray(mask), k=k,
                                     method="none", selector="moment"))
    c_ex = np.asarray(estimate_cov6(jnp.asarray(xyz), jnp.asarray(mask), k=k,
                                    method="none", selector="exact"))
    diff = np.abs(c_mom - c_ex).max(axis=0)[mask]
    scale = np.abs(c_ex).max(axis=0)[mask] + 1e-9
    rel = diff / scale
    # membership is near-exact, but the E[xx] - mu mu^T formula carries an
    # irreducible f32 cancellation at lidar coordinate scale (see
    # voxel/knn.py); a precision downgrade fails these bounds loudly
    assert np.median(rel) < 0.10
    assert np.percentile(rel, 90) < 0.40


def test_moment_selector_post_plane_regularization(rng):
    """After PLANE regularization (the production method) the tail shrinks
    further: regularized planes depend only on the neighborhood
    orientation, not boundary-point churn."""
    n, k = 4096, 20
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    c_mom = np.asarray(estimate_cov6(jnp.asarray(xyz), jnp.asarray(mask), k=k,
                                     method="plane", selector="moment"))
    c_ex = np.asarray(estimate_cov6(jnp.asarray(xyz), jnp.asarray(mask), k=k,
                                    method="plane", selector="exact"))
    diff = np.abs(c_mom - c_ex).max(axis=0)
    assert np.median(diff) < 0.15
    assert (diff > 0.8).mean() < 0.05


# ------------------------------------------------------------- solve_psd


@pytest.mark.parametrize("dim,batch,median_tol", [(3, 4096, 1e-5), (6, 2048, 1e-4)])
def test_solve_psd_vs_f64(rng, dim, batch, median_tol):
    """3x3 takes the adjugate inverse, 6x6 the unrolled Cholesky."""
    a = rng.normal(size=(batch, dim, dim))
    h = (a @ a.transpose(0, 2, 1) + 1e-2 * np.eye(dim)).astype(np.float32)
    rhs = rng.normal(size=(batch, dim)).astype(np.float32)
    x = np.asarray(jax.jit(solve_psd)(jnp.asarray(h), jnp.asarray(rhs)))
    x64 = np.linalg.solve(h.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
    rel = np.linalg.norm(x - x64, axis=1) / (np.linalg.norm(x64, axis=1) + 1e-12)
    assert np.median(rel) < median_tol
    assert rel.max() < 1e-2  # worst conditioned batch entries


# ------------------------------------------------------------ voxel build


def test_voxelmap_fullcap_fast_path_vs_truncating_path(rng):
    """capacity >= N takes the duplicate-slot fast path; capacity < N takes
    the compacting path. Same input, the per-voxel stats seen through
    lookup() must agree."""
    n = 1024
    xyz = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    mask = rng.random(n) < 0.9
    cov6 = jnp.asarray(
        np.tile(np.array([1, 0, 0, 1, 0, 1], np.float32)[:, None], (1, n)))
    xj, mj = jnp.asarray(xyz), jnp.asarray(mask)

    vm_fast = build_voxel_map(xj, cov6, mj, capacity=2048, resolution=2.0)
    vm_slow = build_voxel_map(xj, cov6, mj, capacity=512, resolution=2.0)
    # unique voxels in play must fit the small table for comparability
    n_vox = int(np.asarray(vm_fast.valid).sum())
    assert n_vox < 512, "test scene too dense for the truncating table"

    coord = uniform_coord(jnp.asarray(xyz[:256]), 2.0)
    hit_f, num_f, mean_f, cov_f = [np.asarray(v) for v in lookup(vm_fast, coord, polar=False)]
    hit_s, num_s, mean_s, cov_s = [np.asarray(v) for v in lookup(vm_slow, coord, polar=False)]
    np.testing.assert_array_equal(hit_f, hit_s)
    np.testing.assert_allclose(num_f, num_s, rtol=1e-6)
    np.testing.assert_allclose(mean_f, mean_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cov_f, cov_s, rtol=1e-5, atol=1e-5)


def test_voxelmap_fullcap_stats_vs_numpy_oracle(rng):
    n = 768
    xyz = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    mask = rng.random(n) < 0.85
    cov6 = jnp.asarray(rng.normal(size=(6, n)).astype(np.float32))
    vm = build_voxel_map(jnp.asarray(xyz), cov6, jnp.asarray(mask),
                         capacity=1024, resolution=1.0)
    pack_np = np.asarray(pack_uniform(uniform_coord(jnp.asarray(xyz), 1.0)))
    pack_np = np.where(mask, pack_np, np.iinfo(np.int32).max)
    table = np.asarray(vm.pack)
    valid = np.asarray(vm.valid)
    num = np.asarray(vm.num_points)
    mean = np.asarray(vm.mean)
    c6 = np.asarray(vm.cov6)
    for s in np.where(valid)[0]:
        members = pack_np == table[s]
        assert members.sum() == num[s]
        np.testing.assert_allclose(mean[:, s], xyz[members].mean(axis=0),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            c6[:, s], np.asarray(cov6)[:, members].mean(axis=1), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- keyed reduce


def test_segment_sums_vs_f64(rng):
    """The build's keyed segment reduce at lidar-scale magnitudes."""
    s, n, v = 10, 4096, 512
    vals = (rng.normal(size=(s, n)) * 30.0).astype(np.float32)
    keys = rng.integers(0, 400, size=n).astype(np.int32)
    table = np.arange(v, dtype=np.int32)
    got = np.asarray(segment_sums(jnp.asarray(vals), jnp.asarray(keys), jnp.asarray(table)))
    want = np.zeros((s, v))
    for j in range(v):
        want[:, j] = vals[:, keys == table[j]].astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------------- eig3


def test_eigh3_vs_numpy(rng):
    b = 4096
    a = rng.normal(size=(b, 3, 3))
    m = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    w, vec = jax.jit(eigh3)(jnp.asarray(m))
    w, vec = np.asarray(w), np.asarray(vec)
    w64 = np.linalg.eigvalsh(m.astype(np.float64))
    np.testing.assert_allclose(w, w64, rtol=1e-3, atol=1e-3)
    # eigenvector property: M v = lambda v
    mv = np.einsum("bij,bjk->bik", m, vec)
    lv = w[:, None, :] * vec
    assert np.abs(mv - lv).max() < 5e-2
