"""Scan-to-submap GN and keyframe DB tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from rolo_tpu.geometry import so3
from rolo_tpu.geometry.se3 import SE3
from rolo_tpu.mapping import (
    init_db,
    add_keyframe,
    should_add_keyframe,
    extract_submap,
    scan2map_optimize,
)
from rolo_tpu.pointcloud.cloud import PaddedCloud

RNG = np.random.default_rng(21)


def make_structured_scene(n=3000):
    """Walls + edges suitable for point-to-line and point-to-plane factors."""
    pts = []
    # floor and two walls
    m = n // 3
    pts.append(np.stack([RNG.uniform(-10, 10, m), RNG.uniform(-10, 10, m), np.zeros(m)], -1))
    pts.append(np.stack([np.full(m, 8.0), RNG.uniform(-10, 10, m), RNG.uniform(0, 4, m)], -1))
    pts.append(np.stack([RNG.uniform(-10, 10, m), np.full(m, 9.0), RNG.uniform(0, 4, m)], -1))
    pts = np.concatenate(pts).astype(np.float32)
    pts += RNG.normal(0, 0.005, pts.shape).astype(np.float32)
    # vertical edges (corner features)
    edges = []
    for ex, ey in [(8.0, 9.0), (8.0, -4.0), (-3.0, 9.0)]:
        z = np.linspace(0, 4, 120)
        e = np.stack([np.full_like(z, ex), np.full_like(z, ey), z], -1)
        edges.append(e)
    edges = np.concatenate(edges).astype(np.float32)
    edges += RNG.normal(0, 0.004, edges.shape).astype(np.float32)
    return pts, edges


class TestScan2Map:
    def test_recover_pose(self):
        surf_map, corner_map = make_structured_scene()
        submap_s = PaddedCloud.from_points(surf_map, 4096)
        submap_c = PaddedCloud.from_points(corner_map, 512)

        # scan = subsampled map seen from a perturbed pose
        true_rpy = np.array([0.01, -0.02, 0.05], np.float32)
        true_xyz = np.array([0.2, -0.3, 0.1], np.float32)
        r = np.asarray(so3.rpy_to_matrix(*[jnp.asarray(v) for v in true_rpy]))
        # sensor-frame points: p_sensor = R^T (p_world - t)
        surf_scan = ((surf_map[::2] - true_xyz) @ r).astype(np.float32)
        corner_scan = ((corner_map[::2] - true_xyz) @ r).astype(np.float32)

        sp = PaddedCloud.from_points(surf_scan, 2048)
        cp = PaddedCloud.from_points(corner_scan, 256)

        res = scan2map_optimize(
            jnp.zeros(3), jnp.zeros(3),
            cp.xyz, cp.mask, sp.xyz, sp.mask,
            submap_c, submap_s,
        )
        np.testing.assert_allclose(np.asarray(res.rpy), true_rpy, atol=2e-3)
        np.testing.assert_allclose(np.asarray(res.trans), true_xyz, atol=2e-2)
        assert bool(res.converged)
        assert not bool(res.degenerate)

    def test_degenerate_scene(self):
        # single infinite plane: z/roll/pitch observable, x/y/yaw degenerate
        m = 3000
        pts = np.stack(
            [RNG.uniform(-10, 10, m), RNG.uniform(-10, 10, m), RNG.normal(0, 0.005, m)], -1
        ).astype(np.float32)
        submap_s = PaddedCloud.from_points(pts, 4096)
        submap_c = PaddedCloud(jnp.zeros((64, 3)), jnp.zeros(64, bool))
        scan = PaddedCloud.from_points(pts[::2] + [0, 0, 0.2], 2048)
        res = scan2map_optimize(
            jnp.zeros(3), jnp.zeros(3),
            jnp.zeros((64, 3)), jnp.zeros(64, bool),
            scan.xyz, scan.mask, submap_c, submap_s,
        )
        assert bool(res.degenerate)
        # z corrected toward -0.2 (scan floats 0.2 above map)
        assert abs(float(res.trans[2]) + 0.2) < 0.05
        # degenerate directions (x, y) unmoved
        assert abs(float(res.trans[0])) < 0.02
        assert abs(float(res.trans[1])) < 0.02


class TestKeyframeDB:
    def test_add_and_gate(self):
        db = init_db(16, 64, 128)
        pose = SE3.identity()
        cloud_c = PaddedCloud.from_points(RNG.uniform(-1, 1, (32, 3)), 64)
        cloud_s = PaddedCloud.from_points(RNG.uniform(-1, 1, (100, 3)), 128)
        assert bool(should_add_keyframe(db, pose, 0.5, 0.2))  # first frame
        db = add_keyframe(db, pose, jnp.asarray(0.0), cloud_c, cloud_s)
        assert int(db.count) == 1
        # tiny motion -> gated out
        pose2 = SE3(jnp.asarray(np.eye(3, dtype=np.float32)), jnp.asarray([0.1, 0, 0], jnp.float32))
        assert not bool(should_add_keyframe(db, pose2, 0.5, 0.2))
        # large motion -> allowed
        pose3 = SE3(jnp.asarray(np.eye(3, dtype=np.float32)), jnp.asarray([1.0, 0, 0], jnp.float32))
        assert bool(should_add_keyframe(db, pose3, 0.5, 0.2))

    def test_extract_submap(self):
        db = init_db(16, 64, 128)
        for i in range(5):
            pose = SE3(jnp.eye(3), jnp.asarray([i * 5.0, 0.0, 0.0]))
            pts = RNG.uniform(-1, 1, (50, 3)).astype(np.float32)
            db = add_keyframe(
                db, pose, jnp.asarray(float(i)),
                PaddedCloud.from_points(pts[:20], 64),
                PaddedCloud.from_points(pts, 128),
            )
        corners, surfs = extract_submap(
            db, jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray(100.0),
            search_radius=6.0, recency_sec=0.5, max_nearby=8,
            corner_out_cap=512, surf_out_cap=1024,
            corner_leaf=0.05, surf_leaf=0.05,
        )
        # keyframes at 0 and 5 are in radius; others too far and not recent
        got = surfs.to_numpy()
        assert got.shape[0] > 0
        assert np.max(got[:, 0]) < 5.0 + 1.5  # no points from keyframe at x=10+
        assert int(corners.mask.sum()) > 0


class TestScan2MapVariants:
    """Parity across the speed knobs (ADVICE round-2): the approximate
    k-NN path, the no-candidate (full re-search) path, and the default
    candidate-reuse path must all recover the same pose."""

    def _problem(self):
        surf_map, corner_map = make_structured_scene()
        submap_s = PaddedCloud.from_points(surf_map, 4096)
        submap_c = PaddedCloud.from_points(corner_map, 512)
        true_rpy = np.array([0.01, -0.02, 0.05], np.float32)
        true_xyz = np.array([0.3, -0.2, 0.1], np.float32)
        from rolo_tpu.geometry import so3 as _so3
        r = np.asarray(_so3.rpy_to_matrix(*[jnp.asarray(v) for v in true_rpy]))
        surf_scan = ((surf_map[::3] - true_xyz) @ r).astype(np.float32)
        corner_scan = ((corner_map[::2] - true_xyz) @ r).astype(np.float32)
        sp = PaddedCloud.from_points(surf_scan, 2048)
        cp = PaddedCloud.from_points(corner_scan, 256)
        return cp, sp, submap_c, submap_s, true_rpy, true_xyz

    def _solve(self, cp, sp, submap_c, submap_s, **kw):
        return scan2map_optimize(
            jnp.zeros(3), jnp.zeros(3), cp.xyz, cp.mask, sp.xyz, sp.mask,
            submap_c, submap_s, **kw,
        )

    @pytest.mark.slow
    def test_approx_and_candidate_paths_agree(self):
        cp, sp, submap_c, submap_s, true_rpy, true_xyz = self._problem()
        for kw in (
            dict(approx_knn=True, n_candidates=24),   # production default
            dict(approx_knn=True, n_candidates=0),    # scheduled full rebinds
            dict(approx_knn=False, n_candidates=0),   # reference-exact
        ):
            res = self._solve(cp, sp, submap_c, submap_s, **kw)
            np.testing.assert_allclose(np.asarray(res.rpy), true_rpy, atol=3e-3, err_msg=str(kw))
            np.testing.assert_allclose(np.asarray(res.trans), true_xyz, atol=3e-2, err_msg=str(kw))
            assert bool(res.converged), kw

    def test_stale_candidate_guard_matches_exact_at_large_correction(self):
        """An initial pose off by ~0.7 m (the far edge of scan2map's
        capture range — the <1 m near_ok gate caps it, backMapping.cpp:750)
        moves the GN estimate beyond the bind-time candidate radius; the
        stale-candidate guard (ADVICE round-2 medium) must keep the
        candidate path as good as the full re-search path."""
        cp, sp, submap_c, submap_s, true_rpy, true_xyz = self._problem()
        bad_xyz = jnp.asarray(true_xyz + np.array([0.5, -0.45, 0.0], np.float32))
        exact = scan2map_optimize(
            jnp.asarray(true_rpy), bad_xyz, cp.xyz, cp.mask, sp.xyz, sp.mask,
            submap_c, submap_s, approx_knn=False, n_candidates=0,
            max_iterations=30,
        )
        cand = scan2map_optimize(
            jnp.asarray(true_rpy), bad_xyz, cp.xyz, cp.mask, sp.xyz, sp.mask,
            submap_c, submap_s, approx_knn=True, n_candidates=24,
            max_iterations=30,
        )
        err_exact = np.linalg.norm(np.asarray(exact.trans) - true_xyz)
        err_cand = np.linalg.norm(np.asarray(cand.trans) - true_xyz)
        # the candidate path may not be meaningfully worse than full re-search
        assert err_cand < err_exact + 0.05, (err_cand, err_exact)
