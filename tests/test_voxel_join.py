"""Packed voxel keys and the keyed reductions over them (binary-search
join, segment-sum build): pack exactness, parity with dict-based numpy
oracles, and edge cases (out-of-range bins, empty tables, padding)."""

import jax.numpy as jnp
import numpy as np

from rolo_tpu.ops.voxel_join import (
    INVALID_PACK,
    pack_polar,
    pack_uniform,
    unpack_polar,
    segment_sums,
    unpack_uniform,
)
from rolo_tpu.ops import sym3
from rolo_tpu.voxel.voxelmap import (
    VoxelMap,
    build_voxel_map,
    lookup,
    lookup_join,
    polar_coord,
    uniform_coord,
)


def eye6(n):
    return jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 1.0, 0, 1.0])[:, None], (6, n))


class TestPacking:
    def test_polar_pack_injective(self):
        rng = np.random.default_rng(0)
        coords = np.stack(
            [rng.integers(0, 40, 2000), rng.integers(0, 20, 2000), rng.integers(0, 600, 2000)],
            axis=-1,
        ).astype(np.int32)
        packs = np.asarray(pack_polar(jnp.asarray(coords)))
        uniq_c = len(np.unique(coords, axis=0))
        uniq_p = len(np.unique(packs))
        assert uniq_c == uniq_p  # no collisions for in-range bins
        # exact inverse
        np.testing.assert_array_equal(np.asarray(unpack_polar(jnp.asarray(packs))), coords)

    def test_uniform_pack_injective_and_signed(self):
        rng = np.random.default_rng(1)
        coords = rng.integers(-500, 500, (2000, 3)).astype(np.int32)
        packs = np.asarray(pack_uniform(jnp.asarray(coords)))
        assert len(np.unique(coords, axis=0)) == len(np.unique(packs))
        assert not np.any(packs == int(INVALID_PACK))
        np.testing.assert_array_equal(np.asarray(unpack_uniform(jnp.asarray(packs))), coords)

    def test_out_of_range_maps_invalid(self):
        bad = jnp.asarray([[200, 0, 0], [0, 70, 0], [0, 0, 1 << 20], [-1, 0, 0]], jnp.int32)
        assert bool(jnp.all(pack_polar(bad) == INVALID_PACK))
        badu = jnp.asarray([[600, 0, 0], [0, -600, 0]], jnp.int32)
        assert bool(jnp.all(pack_uniform(badu) == INVALID_PACK))


def _table_map(pack, stats):
    """A VoxelMap over a hand-made ascending pack table: stats [S, V] with
    rows (num, mean x/y/z, cov6...); slots holding INVALID_PACK are empty."""
    pack = jnp.asarray(pack, jnp.int32)
    stats = jnp.asarray(stats, jnp.float32)
    valid = pack != INVALID_PACK
    zeros = jnp.zeros_like(stats[0])
    return VoxelMap(pack=pack, stats=stats, num_points=stats[0], mean=stats[1:4],
                    cov6=stats[4:10], kappa=zeros, valid=valid)


def _voxel_oracle(pts, mask, cov6, coord_fn):
    """dict-based numpy voxel oracle: bin -> (count, mean, mean cov6)."""
    cells = {}
    for i in np.flatnonzero(mask):
        cells.setdefault(tuple(coord_fn(i)), []).append(i)
    return {c: (len(ix), pts[ix].mean(axis=0), cov6[:, ix].mean(axis=1))
            for c, ix in cells.items()}


class TestKeyedMatmul:
    """The keyed primitives: lookup_join (join direction: each query
    matches at most one table row) and segment_sums (build direction:
    each value lands in exactly its key's slot)."""

    def test_exact_select(self):
        stats = np.zeros((10, 4), np.float32)
        stats[:4] = [[1.0, 2, 3, 0], [1, 4, 9, 0], [1, 8, 27, 0], [5, 6, 7, 0]]
        vm = _table_map([10, 20, 30, INVALID_PACK], stats)
        found, num, mean, _ = lookup_join(vm, jnp.asarray([30, 10, 99, INVALID_PACK], jnp.int32))
        np.testing.assert_array_equal(np.asarray(found), [True, True, False, False])
        np.testing.assert_allclose(np.asarray(num), [3, 1, 0, 0])
        np.testing.assert_allclose(np.asarray(mean), [[9, 1, 0, 0], [27, 1, 0, 0], [7, 5, 0, 0]])

    def test_segment_reduce(self):
        # build direction: many values share a key
        keys_k = jnp.asarray([5, 7, 5, 7, 5, 9], jnp.int32)
        vals = jnp.asarray([[1.0, 10, 2, 20, 4, 100]], jnp.float32)
        out = segment_sums(vals, keys_k, jnp.asarray([5, 7, 9, 11], jnp.int32))
        np.testing.assert_allclose(np.asarray(out), [[7, 30, 100, 0]])

    def test_random_vs_numpy(self):
        rng = np.random.default_rng(5)
        k, s = 700, 9
        keys_k = rng.integers(0, 200, k).astype(np.int32)
        # table: ascending unique keys, some of them absent from keys_k
        table = np.unique(np.concatenate([rng.integers(0, 200, 150), [250, 300]])).astype(np.int32)
        vals = rng.normal(size=(s, k)).astype(np.float32)
        got = np.asarray(segment_sums(jnp.asarray(vals), jnp.asarray(keys_k), jnp.asarray(table)))
        eq = (keys_k[:, None] == table[None, :]).astype(np.float64)
        want = vals.astype(np.float64) @ eq
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_empty_table(self):
        keys = jnp.full((128,), INVALID_PACK, jnp.int32)
        vm = _table_map(keys, np.zeros((10, 128), np.float32))
        found, num, mean, cov6 = lookup_join(vm, jnp.asarray([5, INVALID_PACK], jnp.int32))
        assert not bool(jnp.any(found))
        for a in (num, mean, cov6):
            np.testing.assert_allclose(np.asarray(a), 0.0)
        out = segment_sums(jnp.ones((2, 3)), jnp.asarray([1, 2, 3], jnp.int32), keys)
        np.testing.assert_allclose(np.asarray(out), 0.0)


class TestVoxelMap:
    def test_join_matches_binary_search_polar(self):
        """lookup_join / lookup against the dict-based numpy oracle."""
        rng = np.random.default_rng(2)
        pts_np = rng.uniform(-30, 30, (2048, 3)).astype(np.float32)
        mask_np = rng.random(2048) > 0.1
        cov_np = rng.normal(size=(6, 2048)).astype(np.float32)
        pts, mask = jnp.asarray(pts_np), jnp.asarray(mask_np)
        pres = jnp.asarray([0.175, 0.175, 2.0])
        vm = build_voxel_map(pts, jnp.asarray(cov_np), mask, 4096, polar_res=pres)
        bins = np.asarray(polar_coord(pts, pres))
        want = _voxel_oracle(pts_np, mask_np, cov_np, lambda i: bins[i])
        # query with a mix of self points and novel points
        q = jnp.concatenate([pts[:512], pts[:512] + 25.0])
        coord = polar_coord(q, pres)
        f2, n2, m2, c2 = lookup_join(vm, pack_polar(coord))
        f1, n1, m1, c1 = lookup(vm, coord, polar=True)
        qc = [tuple(c) for c in np.asarray(coord)]
        hits = np.array([c in want for c in qc])
        assert 0 < hits.sum() < len(qc)
        np.testing.assert_array_equal(np.asarray(f2), hits)
        np.testing.assert_array_equal(np.asarray(f1), hits)
        for j in np.flatnonzero(hits):
            cnt, mean, cov = want[qc[j]]
            assert float(n2[j]) == cnt
            np.testing.assert_allclose(np.asarray(m2[:, j]), mean, atol=1e-4)
            np.testing.assert_allclose(np.asarray(c2[:, j]), cov, atol=1e-5)
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2).T)
        np.testing.assert_allclose(np.asarray(c1), np.asarray(sym3.to_mat(c2)))
        assert float(jnp.abs(n2[~hits]).max()) == 0.0

    def test_join_matches_binary_search_uniform(self):
        rng = np.random.default_rng(3)
        pts_np = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
        pts = jnp.asarray(pts_np)
        mask = jnp.ones(1024, bool)
        vm = build_voxel_map(pts, eye6(1024), mask, 2048, polar_res=None, resolution=1.0)
        coord = uniform_coord(pts, 1.0)
        want = _voxel_oracle(pts_np, np.ones(1024, bool), np.asarray(eye6(1024)),
                             lambda i: np.floor(pts_np[i] / 1.0 - 0.5).astype(int))
        f2, n2, _, _ = lookup_join(vm, pack_uniform(coord))
        assert float(f2.mean()) == 1.0  # self-hit
        np.testing.assert_array_equal(
            np.asarray(n2), [want[tuple(c)][0] for c in np.asarray(coord)])

    def test_build_matches_numpy_oracle(self):
        """Voxel means/counts against a dict-based numpy reference."""
        rng = np.random.default_rng(4)
        pts = rng.uniform(-8, 8, (512, 3)).astype(np.float32)
        mask = rng.random(512) > 0.2
        vm = build_voxel_map(
            jnp.asarray(pts), eye6(512), jnp.asarray(mask), 1024,
            polar_res=None, resolution=1.0,
        )
        cells = {}
        for p, m in zip(pts, mask):
            if not m:
                continue
            c = tuple(np.floor(p / 1.0 - 0.5).astype(int))
            cells.setdefault(c, []).append(p)
        got_n = int(jnp.sum(vm.valid))
        assert got_n == len(cells)
        coords = np.asarray(vm.coord(polar=False))
        # valid slots are run starts of the sorted pack array, not
        # necessarily compacted to the front (build_voxel_map fast path)
        for v in np.flatnonzero(np.asarray(vm.valid)):
            c = tuple(coords[v])
            assert c in cells
            np.testing.assert_allclose(
                np.asarray(vm.mean[:, v]), np.mean(cells[c], axis=0), atol=1e-4
            )
            assert float(vm.num_points[v]) == len(cells[c])

    def test_negative_coordinate_bins(self):
        """Regression: negative uniform bins must round-trip the build."""
        pts = jnp.asarray([[-5.2, -3.1, -0.4], [-5.3, -3.2, -0.5], [4.0, 2.0, 1.0]], jnp.float32)
        mask = jnp.ones(3, bool)
        vm = build_voxel_map(pts, eye6(3), mask, 128, polar_res=None, resolution=1.0)
        coord = uniform_coord(pts, 1.0)
        f, n, _, _ = lookup_join(vm, pack_uniform(coord))
        assert bool(jnp.all(f))

    def test_capacity_overflow_drops_extra_voxels(self):
        rng = np.random.default_rng(6)
        pts = jnp.asarray(rng.uniform(-50, 50, (256, 3)).astype(np.float32))
        mask = jnp.ones(256, bool)
        vm = build_voxel_map(pts, eye6(256), mask, 16, polar_res=None, resolution=1.0)
        assert int(jnp.sum(vm.valid)) <= 16
        # all kept slots are self-consistent
        f, n, _, _ = lookup_join(vm, vm.pack[:16])
        assert bool(jnp.all(f[np.asarray(vm.valid[:16])]))
