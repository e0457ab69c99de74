"""Pose-graph GN/PCG solver tests: odometry chain with drift + loop closure
must pull the trajectory back to ground truth."""

import numpy as np
import pytest
import jax.numpy as jnp

from rolo_tpu.geometry import so3, se3
from rolo_tpu.graph import empty_graph, add_between, solve_pose_graph

RNG = np.random.default_rng(33)


def build_square_trajectory(k_cap=32, n=12, drift=0.05):
    """Ground truth: a closed square path of n poses. Odometry measurements
    are exact; the initial estimate accumulates drift."""
    true = [se3.SE3(jnp.eye(3), jnp.zeros(3))]
    step_fwd = se3.SE3(
        so3.rpy_to_matrix(jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(2 * np.pi / n)),
        jnp.asarray([2.0, 0.0, 0.0]),
    )
    for _ in range(n - 1):
        true.append(true[-1].compose(step_fwd))

    graph = empty_graph(k_cap, 8, 8)
    rot0 = np.stack([np.asarray(t.rot) for t in true])
    trans0 = np.stack([np.asarray(t.trans) for t in true])

    # odometry relative measurements (exact)
    odom_rot = [np.eye(3, dtype=np.float32)]
    odom_trans = [np.zeros(3, np.float32)]
    for i in range(1, n):
        rel = true[i - 1].inverse().compose(true[i])
        odom_rot.append(np.asarray(rel.rot))
        odom_trans.append(np.asarray(rel.trans))

    # drifted initial estimate: integrate odometry with noise
    est = [true[0]]
    for i in range(1, n):
        noise_w = RNG.normal(0, drift * 0.2, 3).astype(np.float32)
        noise_t = RNG.normal(0, drift, 3).astype(np.float32)
        rel = se3.SE3(jnp.asarray(odom_rot[i]), jnp.asarray(odom_trans[i]))
        pert = se3.SE3(so3.exp(jnp.asarray(noise_w)), jnp.asarray(noise_t))
        est.append(est[-1].compose(rel).compose(pert))

    k = k_cap
    pad_rot = np.broadcast_to(np.eye(3, dtype=np.float32), (k - n, 3, 3))
    rot_est = np.concatenate([np.stack([np.asarray(e.rot) for e in est]), pad_rot])
    trans_est = np.concatenate(
        [np.stack([np.asarray(e.trans) for e in est]), np.zeros((k - n, 3), np.float32)]
    )
    orr = np.concatenate([np.stack(odom_rot), pad_rot])
    ort = np.concatenate([np.stack(odom_trans), np.zeros((k - n, 3), np.float32)])
    graph = graph._replace(
        odom_rel_rot=jnp.asarray(orr),
        odom_rel_trans=jnp.asarray(ort),
        first_rot=jnp.asarray(rot0[0]),
        first_trans=jnp.asarray(trans0[0]),
    )
    return graph, true, jnp.asarray(rot_est), jnp.asarray(trans_est), n


class TestPoseGraph:
    @pytest.mark.slow
    def test_odometry_only_exact(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory(drift=0.03)
        sol = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n), gn_iterations=10)
        # with exact odometry and no loops, the solution must re-integrate
        # the chain exactly from the anchored first pose
        for i in [1, n // 2, n - 1]:
            np.testing.assert_allclose(
                np.asarray(sol.trans[i]), np.asarray(true[i].trans), atol=2e-2
            )

    def test_loop_closure_corrects_drift(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory(drift=0.08)
        # noisy odometry: rebuild relative measurements with noise so the
        # chain alone cannot recover truth
        noisy_rel_rot = np.asarray(graph.odom_rel_rot).copy()
        noisy_rel_trans = np.asarray(graph.odom_rel_trans).copy()
        for i in range(1, n):
            noisy_rel_trans[i] += RNG.normal(0, 0.05, 3).astype(np.float32)
        graph = graph._replace(
            odom_rel_rot=jnp.asarray(noisy_rel_rot),
            odom_rel_trans=jnp.asarray(noisy_rel_trans),
        )
        # loop factor: last pose -> first pose, exact measurement, tight noise
        rel = true[n - 1].inverse().compose(true[0])
        graph = graph._replace(
            loops=add_between(
                graph.loops,
                n - 1,
                0,
                rel.rot,
                rel.trans,
                jnp.asarray([1e-6, 1e-6, 1e-6, 1e-6, 1e-6, 1e-6]),
            )
        )
        sol = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n), gn_iterations=10)

        # end-pose error must be small thanks to the loop
        err_end = np.linalg.norm(np.asarray(sol.trans[n - 1]) - np.asarray(true[n - 1].trans))
        drift_end = np.linalg.norm(np.asarray(trans_est[n - 1]) - np.asarray(true[n - 1].trans))
        assert err_end < 0.25 * drift_end + 0.05, (err_end, drift_end)

    def test_inactive_poses_fixed(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory()
        sol = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n), gn_iterations=3)
        np.testing.assert_allclose(np.asarray(sol.trans[n:]), np.asarray(trans_est[n:]), atol=1e-7)

    def test_robust_loop_rejects_outlier(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory(drift=0.02)
        # a WRONG loop factor with Cauchy robustness: should be downweighted
        bogus = se3.SE3(jnp.eye(3), jnp.asarray([5.0, 5.0, 0.0]))
        graph = graph._replace(
            loops=add_between(
                graph.loops, n - 1, 0, bogus.rot, bogus.trans,
                jnp.asarray([1e-4] * 6), robust_c=jnp.asarray(1.0),
            )
        )
        sol = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n), gn_iterations=10)
        # trajectory should stay near the odometry solution, not the bogus loop
        err = np.linalg.norm(np.asarray(sol.trans[n - 1]) - np.asarray(true[n - 1].trans))
        assert err < 0.6, err


class TestScaleVsOracle:
    """Full-capacity regression vs the f64 sparse-GN oracle
    (tests/oracle_posegraph.py): 2048 poses, 50 loops, 20 prior-style
    factors — the iSAM2-replacement claim checked in the regime where f32
    PCG could stall (VERDICT round-1 item 7)."""

    K = 2048
    N_LOOPS = 50
    N_PRIORS = 20

    def _big_graph(self):
        rng = np.random.default_rng(7)
        k = self.K
        # ground truth: 4 laps of a circle, radius 40 (revisits for loops)
        laps = 4
        th = np.linspace(0, laps * 2 * np.pi, k, endpoint=False)
        true_trans = np.stack([40 * np.cos(th), 40 * np.sin(th), 2 * np.sin(3 * th)], axis=-1)
        yaw = th + np.pi / 2
        true_rot = np.zeros((k, 3, 3))
        c, s = np.cos(yaw), np.sin(yaw)
        true_rot[:, 0, 0] = c
        true_rot[:, 0, 1] = -s
        true_rot[:, 1, 0] = s
        true_rot[:, 1, 1] = c
        true_rot[:, 2, 2] = 1.0

        # exact odometry measurements; noisy integrated estimate
        odom_rot = np.zeros((k, 3, 3))
        odom_trans = np.zeros((k, 3))
        odom_rot[0] = np.eye(3)
        est_rot = np.zeros((k, 3, 3))
        est_trans = np.zeros((k, 3))
        est_rot[0] = true_rot[0]
        est_trans[0] = true_trans[0]
        for i in range(1, k):
            odom_rot[i] = true_rot[i - 1].T @ true_rot[i]
            odom_trans[i] = true_rot[i - 1].T @ (true_trans[i] - true_trans[i - 1])
            noisy_t = odom_trans[i] + rng.normal(0, 0.01, 3)
            est_rot[i] = est_rot[i - 1] @ odom_rot[i]
            est_trans[i] = est_rot[i - 1] @ noisy_t + est_trans[i - 1]

        per_lap = k // laps
        loops = []
        for n in range(self.N_LOOPS):
            j = int(rng.integers(per_lap, k - 1))
            i = j - per_lap  # same spot one lap earlier
            rel_r = true_rot[i].T @ true_rot[j]
            rel_t = true_rot[i].T @ (true_trans[j] - true_trans[i])
            loops.append((i, j, rel_r, rel_t, np.full(6, 1e-4), 1.0 if n % 2 else 0.0))
        priors = []
        for _ in range(self.N_PRIORS):
            j = int(rng.integers(1, k - 1))
            i = max(j - 3, 0)
            rel_r = true_rot[i].T @ true_rot[j]
            rel_t = true_rot[i].T @ (true_trans[j] - true_trans[i])
            priors.append((i, j, rel_r, rel_t, np.array([1e-4, 1e-4, 1e-2, 1e-2, 1e-2, 1e-4]), 0.0))
        return (true_rot, true_trans, odom_rot, odom_trans, est_rot, est_trans, loops, priors)

    @pytest.mark.slow
    def test_full_capacity_matches_f64_oracle(self):
        from oracle_posegraph import solve_pose_graph_oracle
        from rolo_tpu.graph.factors import FIRST_PRIOR_VARIANCES, ODOM_VARIANCES

        (true_rot, true_trans, odom_rot, odom_trans,
         est_rot, est_trans, loops, priors) = self._big_graph()
        k = self.K

        graph = empty_graph(k, 64, 32)
        graph = graph._replace(
            odom_rel_rot=jnp.asarray(odom_rot, jnp.float32),
            odom_rel_trans=jnp.asarray(odom_trans, jnp.float32),
            first_rot=jnp.asarray(true_rot[0], jnp.float32),
            first_trans=jnp.asarray(true_trans[0], jnp.float32),
        )
        for (i, j, rr, rt, var, rc) in loops:
            graph = graph._replace(loops=add_between(
                graph.loops, i, j, jnp.asarray(rr, jnp.float32), jnp.asarray(rt, jnp.float32),
                jnp.asarray(var, jnp.float32), robust_c=jnp.asarray(rc, jnp.float32)))
        for (i, j, rr, rt, var, rc) in priors:
            graph = graph._replace(priors=add_between(
                graph.priors, i, j, jnp.asarray(rr, jnp.float32), jnp.asarray(rt, jnp.float32),
                jnp.asarray(var, jnp.float32)))

        sol = solve_pose_graph(
            graph, jnp.asarray(est_rot, jnp.float32), jnp.asarray(est_trans, jnp.float32),
            jnp.asarray(k),
        )
        assert bool(sol.converged)

        oracle_rot, oracle_trans, oracle_chi2 = solve_pose_graph_oracle(
            est_rot, est_trans, odom_rot, odom_trans, true_rot[0], true_trans[0],
            loops + priors, ODOM_VARIANCES, FIRST_PRIOR_VARIANCES, iterations=8,
        )

        diff = np.linalg.norm(np.asarray(sol.trans) - oracle_trans, axis=1)
        assert diff.max() < 1e-3, (diff.max(), diff.mean())
        # both must beat the drifted input by a wide margin
        in_err = np.linalg.norm(est_trans - true_trans, axis=1).max()
        out_err = np.linalg.norm(np.asarray(sol.trans) - true_trans, axis=1).max()
        assert out_err < 0.2 * in_err, (out_err, in_err)


class TestDenseMethod:
    """The dense blocked-Cholesky solve (method="dense") must agree with the
    matrix-free PCG path — it is the oracle the production "bcr" method is
    pinned against (solve_graph_host switched dense -> bcr in round 5)."""

    @pytest.mark.slow
    def test_dense_matches_pcg_with_loop(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory()
        rel = true[n - 1].inverse().compose(true[0])
        graph = graph._replace(loops=add_between(
            graph.loops, n - 1, 0, rel.rot, rel.trans,
            jnp.full(6, 1e-4), robust_c=jnp.asarray(0.1)))
        sol_d = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n),
                                 gn_iterations=10, method="dense")
        sol_p = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n),
                                 gn_iterations=10, method="pcg")
        assert np.allclose(np.asarray(sol_d.trans[:n]), np.asarray(sol_p.trans[:n]),
                           atol=5e-3), np.abs(np.asarray(sol_d.trans[:n]) - np.asarray(sol_p.trans[:n])).max()
        err = np.linalg.norm(
            np.asarray(sol_d.trans[n - 1]) - np.asarray(true[n - 1].trans))
        assert err < 0.05, err

    def test_dense_inactive_poses_fixed(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory()
        sol = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n),
                               gn_iterations=3, method="dense")
        assert np.allclose(np.asarray(sol.trans[n:]), np.asarray(trans_est[n:]))


class TestBcrMethod:
    """Block-cyclic-reduction + Woodbury solve (method="bcr", solver.py
    _bcr_step): the structure-exploiting replacement for the [6K, 6K]
    dense Cholesky whose cost grows ~cubically with the bucket. Must agree
    with method="dense" on the same graph."""

    def test_bcr_matches_dense_with_loops_and_priors(self):
        graph, true, rot_est, trans_est, n = build_square_trajectory()
        rel = true[n - 1].inverse().compose(true[0])
        graph = graph._replace(loops=add_between(
            graph.loops, n - 1, 0, rel.rot, rel.trans,
            jnp.full(6, 1e-4), robust_c=jnp.asarray(0.1)))
        # a ground-prior-style between factor too (separate factor store)
        rel2 = true[2].inverse().compose(true[5])
        graph = graph._replace(priors=add_between(
            graph.priors, 2, 5, rel2.rot, rel2.trans, jnp.full(6, 1e-3)))
        sol_d = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n),
                                 gn_iterations=10, method="dense")
        sol_b = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(n),
                                 gn_iterations=10, method="bcr")
        np.testing.assert_allclose(np.asarray(sol_b.trans[:n]),
                                   np.asarray(sol_d.trans[:n]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(sol_b.rot[:n]),
                                   np.asarray(sol_d.rot[:n]), atol=1e-4)
        assert abs(float(sol_b.final_error) - float(sol_d.final_error)) <= (
            1e-3 * (1.0 + float(sol_d.final_error)))

    def test_bcr_odd_and_masked_counts(self):
        # odd live count inside a power-of-two capacity exercises the
        # per-level padding path; inactive poses must stay fixed
        graph, true, rot_est, trans_est, n = build_square_trajectory()
        count = n - 3  # odd region
        sol_d = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(count),
                                 gn_iterations=5, method="dense")
        sol_b = solve_pose_graph(graph, rot_est, trans_est, jnp.asarray(count),
                                 gn_iterations=5, method="bcr")
        np.testing.assert_allclose(np.asarray(sol_b.trans[:count]),
                                   np.asarray(sol_d.trans[:count]), atol=1e-4)
        assert np.allclose(np.asarray(sol_b.trans[count:]),
                           np.asarray(trans_est[count:]))

    def test_bcr_solve_linear_oracle(self):
        # the tridiagonal solver alone vs a dense f64 oracle on a random
        # SPD block-tridiagonal system (non-power-of-two K)
        from rolo_tpu.graph.solver import _bcr_solve

        rng = np.random.default_rng(7)
        k = 37
        a = rng.normal(size=(k, 6, 6)).astype(np.float32)
        d = np.einsum("kij,klj->kil", a, a) + 6.0 * np.eye(6, dtype=np.float32)
        e = 0.3 * rng.normal(size=(k - 1, 6, 6)).astype(np.float32)
        b = rng.normal(size=(k, 6, 3)).astype(np.float32)
        t = np.zeros((k * 6, k * 6))
        for i in range(k):
            t[i * 6:(i + 1) * 6, i * 6:(i + 1) * 6] = d[i]
        for i in range(k - 1):
            t[i * 6:(i + 1) * 6, (i + 1) * 6:(i + 2) * 6] = e[i]
            t[(i + 1) * 6:(i + 2) * 6, i * 6:(i + 1) * 6] = e[i].T
        want = np.linalg.solve(t, b.reshape(k * 6, 3)).reshape(k, 6, 3)
        got = np.asarray(_bcr_solve(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


class TestSolveGraphHost:
    """Bucketed host-driven solve (mapping.backend.solve_graph_host): the
    smallest capacity bucket covering the live count is compiled, poses are
    corrected in the full-capacity DB, and pending_solve clears."""

    @pytest.mark.slow
    def test_bucketed_solve_corrects_and_clears(self):
        import dataclasses
        from rolo_tpu.config import RoloConfig, StaticConfig
        from rolo_tpu.mapping import backend as bk
        from rolo_tpu.mapping.keyframes import add_keyframe
        from rolo_tpu.pointcloud.cloud import PaddedCloud

        cfg = RoloConfig(static=StaticConfig(
            max_keyframes=256, max_corner_points=64, max_surf_points=64,
            max_submap_points=256, max_loop_factors=8, max_prior_factors=8))
        st = bk.init_backend(cfg)
        graph, true, rot_est, trans_est, n = build_square_trajectory(k_cap=256)
        db = st.db
        cloud = PaddedCloud(jnp.zeros((64, 3)), jnp.zeros(64, bool))
        for i in range(n):
            db = add_keyframe(db, se3.SE3(rot_est[i], trans_est[i]),
                              jnp.asarray(float(i)), cloud, cloud)
        from rolo_tpu.geometry import so3 as _so3

        # current pose = the latest keyframe's estimate (the solve applies
        # the latest keyframe's correction DELTA to it; with the current
        # pose at the keyframe, the corrected pose IS the solved keyframe)
        r_, p_, y_ = _so3.matrix_to_rpy(rot_est[n - 1])
        st = st._replace(db=db, graph=st.graph._replace(
            odom_rel_rot=graph.odom_rel_rot, odom_rel_trans=graph.odom_rel_trans,
            first_rot=graph.first_rot, first_trans=graph.first_trans),
            pending_solve=jnp.asarray(True),
            rpy=jnp.stack([r_, p_, y_]), xyz=trans_est[n - 1])
        rel = true[n - 1].inverse().compose(true[0])
        st = st._replace(graph=st.graph._replace(loops=add_between(
            st.graph.loops, n - 1, 0, rel.rot, rel.trans, jnp.full(6, 1e-4))))

        st2 = bk.solve_graph_host(st, cfg)
        assert not bool(st2.pending_solve)
        err = np.linalg.norm(
            np.asarray(st2.db.trans[n - 1]) - np.asarray(true[n - 1].trans))
        drift = np.linalg.norm(
            np.asarray(st.db.trans[n - 1]) - np.asarray(true[n - 1].trans))
        assert err < 0.3 * drift, (err, drift)
        # transformTobeMapped receives the latest keyframe's correction
        # delta; with the current pose sitting AT that keyframe, the
        # corrected pose equals the solved keyframe pose
        assert np.allclose(
            np.asarray(st2.xyz), np.asarray(st2.db.trans[n - 1]), atol=1e-4
        )
        # untouched capacity tail
        assert np.allclose(np.asarray(st2.db.trans[n:]), np.asarray(st.db.trans[n:]))


class TestMarginalCovariance:
    """isam->marginalCovariance analog (backMapping.cpp:1161)."""

    def _chain(self, k=12, n=8):
        from rolo_tpu.graph.factors import empty_graph

        rng = np.random.default_rng(0)
        g = empty_graph(k, 4, 4)
        rel_t = np.zeros((k, 3), np.float32)
        rel_t[:, 0] = 1.0
        g = g._replace(odom_rel_trans=jnp.asarray(rel_t))
        rot = jnp.broadcast_to(jnp.eye(3), (k, 3, 3))
        trans = jnp.asarray(
            np.cumsum(np.vstack([np.zeros((1, 3)), rel_t[1:n]]), axis=0).astype(np.float32))
        trans = jnp.concatenate([trans, jnp.zeros((k - n, 3))])
        return g, rot, trans, jnp.asarray(n)

    def test_matches_dense_inverse(self):
        from rolo_tpu.graph import solver as S

        g, rot, trans, count = self._chain()
        k = rot.shape[0]
        keys = jnp.asarray([0, 3, 7], jnp.int32)
        got = np.asarray(S.marginal_covariance(g, rot, trans, count, keys))
        # oracle: explicit dense inverse of the same H
        active = (jnp.arange(k) < count)[:, None]
        blocks = S._linearize(g, rot, trans, count)
        h = np.asarray(S._dense_hessian(blocks, k, jnp.asarray(1e-6), active), np.float64)
        hinv = np.linalg.inv(h)
        for m, key in enumerate([0, 3, 7]):
            want = hinv[key * 6:(key + 1) * 6, key * 6:(key + 1) * 6]
            np.testing.assert_allclose(got[m], want, rtol=1e-3, atol=1e-7)

    def test_uncertainty_grows_along_chain(self):
        from rolo_tpu.graph import solver as S

        g, rot, trans, count = self._chain()
        keys = jnp.asarray([1, 4, 7], jnp.int32)
        cov = np.asarray(S.marginal_covariance(g, rot, trans, count, keys))
        # symmetric PSD, and odometry-only uncertainty accumulates with
        # distance from the anchored first pose
        tr = [np.trace(c) for c in cov]
        for c in cov:
            np.testing.assert_allclose(c, c.T, atol=1e-8)
            assert np.linalg.eigvalsh(c).min() > -1e-9
        assert tr[0] < tr[1] < tr[2]
