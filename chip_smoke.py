"""Bring-up smoke test: rolo_tpu's main SLAM path on one NVIDIA GPU.

    python chip_smoke.py               # one card: device, kernels, registration, slam
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Each phase prints one line with its result and wall time; any failed check
raises, so the process exits non-zero and prints no result line. The last
line of a passing run is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Phases (one card):
  device        the JAX backend is a GPU; the card's name and power limit
  kernels       every primitive of the main path at production widths
                against its plain reference (f64 numpy or an exact path)
  registration  bench.py's workload and accuracy gate (16 raycast 32x1024
                scan pairs, zero initial guess)
  slam          the CLI `run` over 400 simulated 32x1024 scans with loops,
                priors and graph solves on, gated on the golden band of
                tests/test_sim.py

Four cards (--four-cards): data-parallel registration of the 16 bench
pairs, the point-sharded registration, and batched mapping, each against
the same computation on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

# tolerances shared by the four-card comparisons: XLA may pick other
# algorithms per batch size and the psum order differs across cards, so
# sharded poses agree with one-card poses to well below the solver's own
# accuracy, not bit for bit
SHARD_ROT_DEG = 0.05
SHARD_TRANS_M = 0.005


def require_gpu():
    """Exit non-zero unless JAX's default backend is a GPU; returns the
    first device."""
    import jax

    backend = jax.default_backend()
    dev = jax.devices()[0]
    if backend != "gpu" or dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX backend is {backend!r}")
    return dev


def _phase(name: str, t0: float, **results) -> None:
    fields = " ".join(f"{k}={v}" for k, v in results.items())
    print(f"[{name}] ok {fields} wall_s={time.perf_counter() - t0:.1f}", flush=True)


# ---------------------------------------------------------------- kernels


def _lidar_cloud(rng, n):
    """Points on a few walls and a ground plane, 2-60 m from the sensor."""
    ground = np.c_[rng.uniform(-60, 60, (n // 2, 2)), rng.normal(-1.8, 0.02, n // 2)]
    walls = []
    for i in range(4):
        a = i * np.pi / 2 + 0.3
        d = 12.0 + 10.0 * i
        u = rng.uniform(-25, 25, n // 8)
        z = rng.uniform(-1.8, 4.0, n // 8)
        walls.append(np.c_[d * np.cos(a) - u * np.sin(a), d * np.sin(a) + u * np.cos(a), z])
    pts = np.concatenate([ground] + walls)[:n]
    return (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)


def _check_voxel_map(rng) -> dict:
    """Voxel build and bind at production widths (table max_voxels = 8192,
    queries O x max_feature_points with O = 7 neighbour offsets) against a
    dict-based numpy oracle. Hits and counts must be exact. Means and
    covariances are f32 sums of at most a few hundred terms taken in
    another order: 1e-5 relative to the mean magnitude of the summed
    terms (a mean of mixed-sign terms can be far smaller than its
    terms)."""
    import jax
    import jax.numpy as jnp

    from rolo_tpu.config import RegistrationConfig, RoloConfig
    from rolo_tpu.registration.gicp import OFFSETS
    from rolo_tpu.voxel.voxelmap import build_voxel_map, lookup_join, polar_coord
    from rolo_tpu.ops.voxel_join import pack_polar

    st = RoloConfig().static
    n, v = st.max_feature_points, st.max_voxels
    pres = np.asarray(RegistrationConfig().polar_resolution, np.float32)
    xyz = _lidar_cloud(rng, n)
    mask = rng.random(n) < 0.9
    cov6 = rng.normal(size=(6, n)).astype(np.float32)
    offsets = np.asarray(OFFSETS["direct7"], np.int32)

    @jax.jit
    def build_and_bind(xyz, cov6, mask, query):
        vm = build_voxel_map(xyz, cov6, mask, v, polar_res=jnp.asarray(pres))
        coord = polar_coord(query, jnp.asarray(pres))  # [N, 3]
        packs = pack_polar(coord[None, :, :] + jnp.asarray(offsets)[:, None, :])
        return vm, lookup_join(vm, packs.reshape(-1)), coord

    query = (xyz + rng.normal(0, 0.3, xyz.shape)).astype(np.float32)
    vm, (found, num, mean, c6), coord = jax.block_until_ready(
        build_and_bind(jnp.asarray(xyz), jnp.asarray(cov6), jnp.asarray(mask),
                       jnp.asarray(query)))
    assert vm.capacity == v

    # oracle: bins from the same f32 polar binning (binning is not under test)
    bins = np.asarray(polar_coord(jnp.asarray(xyz), jnp.asarray(pres)))
    cells = {}
    for i in np.flatnonzero(mask):
        cells.setdefault(tuple(bins[i]), []).append(i)
    want = {c: (len(ix), xyz[ix].astype(np.float64).mean(0),
                cov6[:, ix].astype(np.float64).mean(1),
                np.abs(xyz[ix]).mean(0), np.abs(cov6[:, ix]).mean(1))
            for c, ix in cells.items()}
    assert int(np.asarray(vm.valid).sum()) == len(want), "voxel count"

    qc = (np.asarray(coord)[None, :, :] + offsets[:, None, :]).reshape(-1, 3)
    found, num = np.asarray(found), np.asarray(num)
    mean, c6 = np.asarray(mean).T, np.asarray(c6).T
    hits = np.array([tuple(c) in want for c in qc])
    assert np.array_equal(found, hits), "bind hits differ from the oracle"
    w_num = np.array([want[tuple(c)][0] for c in qc[hits]])
    w_mean = np.stack([want[tuple(c)][1] for c in qc[hits]])
    w_cov = np.stack([want[tuple(c)][2] for c in qc[hits]])
    s_mean = np.stack([want[tuple(c)][3] for c in qc[hits]])
    s_cov = np.stack([want[tuple(c)][4] for c in qc[hits]])
    assert np.array_equal(num[hits], w_num), "voxel counts differ"
    assert np.all(num[~hits] == 0) and np.all(mean[~hits] == 0)
    mean_rel = (np.abs(mean[hits] - w_mean) / s_mean).max()
    cov_rel = (np.abs(c6[hits] - w_cov) / s_cov).max()
    assert mean_rel < 1e-5 and cov_rel < 1e-5, (mean_rel, cov_rel)
    return {"voxels": len(want), "queries": qc.shape[0], "hits": int(hits.sum()),
            "mean_rel_max": f"{mean_rel:.1e}", "cov_rel_max": f"{cov_rel:.1e}"}


def _d2_f64(q, c):
    """[Q, C] squared distances in f64 (its cancellation error at lidar
    range is ~1e-12 m^2)."""
    q, c = q.astype(np.float64), c.astype(np.float64)
    return (q * q).sum(1)[:, None] - 2.0 * q @ c.T + (c * c).sum(1)[None, :]


def _cov_f64(xyz, k):
    """Reference covariances (sum/k, mean-centred) of the exact k-NN, f64."""
    x = xyz.astype(np.float64)
    out = np.zeros((len(x), 6))
    for s in range(0, len(x), 1024):
        d2 = _d2_f64(x[s:s + 1024], x)
        idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
        nb = x[idx]
        c = nb - nb.mean(1, keepdims=True)
        cov = np.einsum("nki,nkj->nij", c, c) / k
        out[s:s + 1024] = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    return out.T


def _check_covariances(rng) -> dict:
    """estimate_cov6 at N = 8192 lidar-scale points: the exact selector
    against an f64 oracle (f32 mean-centred sums: median 1e-3 relative),
    and the production moment selector against the exact selector with
    the bounds the moment formula's f32 cancellation allows (E[xx] -
    mu mu^T at ~50 m coordinates): median < 0.10, p90 < 0.40 before
    regularization, median < 0.15 after PLANE regularization."""
    import jax.numpy as jnp

    from rolo_tpu.voxel.knn import estimate_cov6

    n, k = 8192, 20
    xyz = (rng.normal(size=(n, 3)) * 0.5 + rng.uniform(20.0, 50.0, size=(n, 1))).astype(np.float32)
    mask = np.ones(n, bool)
    args = (jnp.asarray(xyz), jnp.asarray(mask))
    c_ex = np.asarray(estimate_cov6(*args, k=k, method="none", selector="exact"))
    c_mom = np.asarray(estimate_cov6(*args, k=k, method="none", selector="moment"))
    c64 = _cov_f64(xyz, k)

    def rel(a, b):
        return np.abs(a - b).max(0) / (np.abs(b).max(0) + 1e-9)

    ex64 = rel(c_ex, c64)
    mom = rel(c_mom, c_ex)
    mom64 = rel(c_mom, c64)
    assert np.median(ex64) < 1e-3, np.median(ex64)
    assert np.median(mom) < 0.10 and np.percentile(mom, 90) < 0.40, (
        np.median(mom), np.percentile(mom, 90))
    p_ex = np.asarray(estimate_cov6(*args, k=k, method="plane", selector="exact"))
    p_mom = np.asarray(estimate_cov6(*args, k=k, method="plane", selector="moment"))
    plane = np.abs(p_mom - p_ex).max(0)
    assert np.median(plane) < 0.15 and (plane > 0.8).mean() < 0.05, np.median(plane)
    return {"exact_vs_f64_median": f"{np.median(ex64):.1e}",
            "moment_vs_exact_median": f"{np.median(mom):.3f}",
            "moment_vs_exact_p90": f"{np.percentile(mom, 90):.3f}",
            "moment_vs_f64_median": f"{np.median(mom64):.3f}",
            "plane_median": f"{np.median(plane):.3f}"}


def _check_knn(rng, nq, nc, k, n_check=1024) -> dict:
    """knn_indices in the matmul form at a production shape against f64
    brute force on a sample of n_check query rows. A neighbour counts as
    wrong only if its true distance exceeds the true k-th distance by more
    than 0.02 m^2: the matmul form's f32 cancellation noise at lidar range
    is ~5e-3 m^2, and its consumers gate correspondences at 0.3-1 m."""
    import jax.numpy as jnp

    from rolo_tpu.voxel.knn import knn_indices

    cand = _lidar_cloud(rng, nc)
    query = (cand[rng.choice(nc, nq, replace=False)]
             + rng.normal(0, 0.05, (nq, 3))).astype(np.float32)
    idx = np.asarray(knn_indices(jnp.asarray(query), jnp.ones(nq, bool),
                                 jnp.asarray(cand), jnp.ones(nc, bool), k))
    rows = rng.choice(nq, n_check, replace=False)
    d2 = _d2_f64(query[rows], cand)
    kth = np.partition(d2, k - 1, axis=1)[:, k - 1]
    true_set = np.argsort(d2, axis=1)[:, :k]
    got_d2 = np.take_along_axis(d2, idx[rows], axis=1)
    mismatch = np.mean([len(set(a) ^ set(b)) > 0 for a, b in zip(idx[rows], true_set)])
    worst = (got_d2 - kth[:, None]).max()
    assert worst < 0.02, f"knn [{nq}x{nc}] k={k}: neighbour {worst:.3g} m^2 past the true k-th"
    return {f"knn_{nq}x{nc}_k{k}_mismatch": f"{mismatch:.4f}",
            f"knn_{nq}x{nc}_k{k}_excess_m2": f"{max(worst, 0.0):.1e}"}


def _check_small_solvers(rng) -> dict:
    """solve_psd 3x3 (adjugate) and 6x6 (unrolled Cholesky) and eigh3
    against f64: median relative error 1e-5 (3x3) / 1e-4 (6x6), worst
    1e-2 on the badly conditioned tail of random SPD batches; eigenvalues
    1e-3 relative and |Mv - lambda v| < 5e-2 (closed-form f32
    trigonometric solution)."""
    import jax
    import jax.numpy as jnp

    from rolo_tpu.ops.eig3 import eigh3
    from rolo_tpu.ops.linalg import solve_psd

    out = {}
    for dim, b, med in ((3, 4096, 1e-5), (6, 2048, 1e-4)):
        a = rng.normal(size=(b, dim, dim))
        h = (a @ a.transpose(0, 2, 1) + 1e-2 * np.eye(dim)).astype(np.float32)
        rhs = rng.normal(size=(b, dim)).astype(np.float32)
        x = np.asarray(jax.jit(solve_psd)(jnp.asarray(h), jnp.asarray(rhs)))
        x64 = np.linalg.solve(h.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
        r = np.linalg.norm(x - x64, axis=1) / (np.linalg.norm(x64, axis=1) + 1e-12)
        assert np.median(r) < med and r.max() < 1e-2, (dim, np.median(r), r.max())
        out[f"solve{dim}_median"] = f"{np.median(r):.1e}"
    a = rng.normal(size=(4096, 3, 3))
    m = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    w, vec = (np.asarray(t) for t in jax.jit(eigh3)(jnp.asarray(m)))
    np.testing.assert_allclose(w, np.linalg.eigvalsh(m.astype(np.float64)), rtol=1e-3, atol=1e-3)
    resid = np.abs(np.einsum("bij,bjk->bik", m, vec) - w[:, None, :] * vec).max()
    assert resid < 5e-2, resid
    out["eigh3_resid"] = f"{resid:.1e}"
    return out


def phase_kernels() -> None:
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    res = {}
    res.update(_check_voxel_map(rng))
    res.update(_check_covariances(rng))
    res.update(_check_knn(rng, 4096, 16384, 1))  # loop-closure ICP
    res.update(_check_knn(rng, 12288, 32768, 5))  # scan-to-submap bind
    res.update(_check_small_solvers(rng))
    _phase("kernels", t0, **res)


# ----------------------------------------------------------- registration


def phase_registration() -> None:
    import jax
    import jax.numpy as jnp

    import bench

    t0 = time.perf_counter()
    batch = 16
    src, src_mask, tgt, tgt_mask, gt_rot, gt_trans = bench._build_pairs(batch)
    args = tuple(jnp.asarray(a) for a in (src, src_mask, tgt, tgt_mask))
    dt = jnp.full((batch,), 0.2, jnp.float32)
    one = jax.jit(bench.batched_registration(batch))
    zeros = jnp.zeros((batch, 3))
    t_c = time.perf_counter()
    res = jax.block_until_ready(one(*args, zeros, zeros, dt))
    compile_s = time.perf_counter() - t_c
    rot_err, trans_err = bench.pose_errors(gt_rot, gt_trans, res.rot, res.trans)
    bench.check_accuracy(rot_err, trans_err)
    regs = bench.registrations_per_s(bench.batched_registration(batch), *args, dt)
    _phase("registration", t0, pairs=batch,
           rot_err_median_deg=f"{np.median(rot_err):.3f}",
           trans_err_median_m=f"{np.median(trans_err):.4f}",
           first_call_s=f"{compile_s:.1f}", reg_per_s=f"{regs:.1f}")


# ------------------------------------------------------------------- slam


def phase_slam() -> None:
    """The CLI at RoloConfig() defaults. With configs/params.yaml +
    prior_pose_params.yaml the same run holds the ATE and z bounds on the
    card but accepts only 2 prior factors (PERF.md, bring-up); the band is
    not loosened for it."""
    from rolo_tpu.__main__ import main as cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        rc = cli(["run", "--input", "sim", "--sim-scans", "400", "--sim-cols", "1024",
                  "--sim-period", "24", "--sim-seed", "0", "--progress", "0",
                  "--output", out])
        assert rc == 0, rc
        with open(os.path.join(out, "result.json")) as f:
            res = json.load(f)
    # golden band of tests/test_sim.py (test_golden_long_run_band)
    assert res["n_scans"] == 400, res
    assert res["ate_keyframes_rmse_m"] < 0.12, res
    assert res["ate_keyframes_z_rmse_m"] < 0.02, res
    assert res["n_loop_factors"] > 2, res
    assert res["n_prior_factors"] > 2, res
    assert all(v == 0 for v in res["drop_counts"].values()), res
    _phase("slam", t0, scans=res["n_scans"],
           ate_keyframes_m=res["ate_keyframes_rmse_m"],
           z_rmse_m=res["ate_keyframes_z_rmse_m"],
           loops=res["n_loop_factors"], priors=res["n_prior_factors"],
           keyframes=res["n_keyframes"], first_scan_s=res["first_scan_s"],
           scan_ms_p50=res["scan_ms_p50"], scan_ms_p99=res["scan_ms_p99"])


# ------------------------------------------------------------- four cards


def _pose_diff(rot_a, trans_a, rot_b, trans_b):
    import bench

    d_rot = bench.rotation_angle_deg(np.asarray(rot_a).reshape(-1, 3, 3),
                                     np.asarray(rot_b).reshape(-1, 3, 3))
    d_trans = np.linalg.norm(np.asarray(trans_a).reshape(-1, 3) - np.asarray(trans_b).reshape(-1, 3), axis=1)
    return d_rot, d_trans


def _shard_report(name, arr) -> str:
    shards = arr.addressable_shards
    assert len({s.device.id for s in shards}) == len(shards), name
    return f"{name}:" + ",".join(f"d{s.device.id}{list(s.data.shape)}" for s in shards)


def _memory_report(devices) -> str:
    """bytes in use per device (the CPU backend keeps no such stats)."""
    stats = {d.id: d.memory_stats() or {} for d in devices}
    return " ".join(f"d{i}={s.get('bytes_in_use', 0) / 2**20:.0f}MiB" for i, s in stats.items())


def four_cards() -> int:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import bench
    from __graft_entry__ import batched_mapping
    from rolo_tpu.config import RegistrationConfig, RoloConfig
    from rolo_tpu.parallel.spmd import register_scan_pair_spmd
    from rolo_tpu.registration.rotgicp import register_scan_pair

    devices = jax.devices()
    assert len(devices) == 4, f"--four-cards needs 4 GPUs, JAX sees {len(devices)}"
    one_card = devices[:1]

    # 1. data-parallel registration: the 16 bench pairs, 4 per card
    t0 = time.perf_counter()
    batch = 16
    src, src_mask, tgt, tgt_mask, gt_rot, gt_trans = bench._build_pairs(batch)
    host = (src, src_mask, tgt, tgt_mask, np.zeros((batch, 3), np.float32),
            np.zeros((batch, 3), np.float32), np.full((batch,), 0.2, np.float32))
    step = jax.jit(bench.batched_registration(batch))
    dp = NamedSharding(Mesh(np.array(devices), ("batch",)), P("batch"))
    sharded = [jax.device_put(a, dp) for a in host]
    res4 = jax.block_until_ready(step(*sharded))
    res1 = jax.block_until_ready(step(*[jax.device_put(a, one_card[0]) for a in host]))
    print(_shard_report("dp src", sharded[0]), _shard_report("dp rot", res4.rot), flush=True)
    print("dp memory", _memory_report(devices), flush=True)
    rot4, trans4 = bench.pose_errors(gt_rot, gt_trans, res4.rot, res4.trans)
    bench.check_accuracy(rot4, trans4)
    d_rot, d_trans = _pose_diff(res4.rot, res4.trans, res1.rot, res1.trans)
    assert d_rot.max() < SHARD_ROT_DEG and d_trans.max() < SHARD_TRANS_M, (d_rot, d_trans)
    _phase("four_cards_dp", t0, pairs=batch,
           rot_err_median_deg=f"{np.median(rot4):.3f}",
           trans_err_median_m=f"{np.median(trans4):.4f}",
           rot_err_max_deg=f"{rot4.max():.3f}", trans_err_max_m=f"{trans4.max():.4f}",
           vs_one_card_max_deg=f"{d_rot.max():.2e}", vs_one_card_max_m=f"{d_trans.max():.2e}")

    # 2. point-sharded registration of one 8192-point pair
    t0 = time.perf_counter()
    cfg = RegistrationConfig()
    cap = RoloConfig().static.max_voxels
    n = 8192
    pair = [jnp.asarray(a[0, :n]) for a in (src, src_mask, tgt, tgt_mask)]
    z3 = jnp.zeros(3)
    dt = jnp.asarray(0.2, jnp.float32)
    mesh = Mesh(np.array(devices), ("point",))
    sp = jax.block_until_ready(register_scan_pair_spmd(
        mesh, *pair, z3, z3, dt, dt, cfg, cap, cfg.k_correspondences))
    ref = jax.block_until_ready(jax.jit(
        lambda s, sm, t, tm: register_scan_pair(
            s, sm, t, tm, z3, z3, dt, dt, cfg, cap, cfg.k_correspondences))(*pair))
    print("spmd memory", _memory_report(devices), flush=True)
    d_rot, d_trans = _pose_diff(sp.rot, sp.trans, ref.rot, ref.trans)
    assert d_rot.max() < SHARD_ROT_DEG and d_trans.max() < SHARD_TRANS_M, (d_rot, d_trans)
    sp_rot, sp_trans = bench.pose_errors(gt_rot[:1], gt_trans[:1], np.asarray(sp.rot)[None],
                                         np.asarray(sp.trans)[None])
    _phase("four_cards_spmd", t0, points=n, rot_err_deg=f"{sp_rot[0]:.3f}",
           trans_err_m=f"{sp_trans[0]:.4f}",
           vs_one_card_deg=f"{d_rot.max():.2e}", vs_one_card_m=f"{d_trans.max():.2e}")

    # 3. batched mapping + vmapped graph solve, B = 4 sequences
    t0 = time.perf_counter()
    kf4, err4, drift4, states = batched_mapping(devices, 4)
    kf1, _, _, _ = batched_mapping(one_card, 4)
    print(_shard_report("mapping db.trans", states.db.trans), flush=True)
    print("mapping memory", _memory_report(devices), flush=True)
    assert err4.max() < 0.25 and drift4 < 0.05, (err4, drift4)
    d_map = np.linalg.norm(kf4 - kf1, axis=-1).max()
    assert d_map < SHARD_TRANS_M, d_map
    _phase("four_cards_mapping", t0, sequences=4, kf_err_max_m=f"{err4.max():.3f}",
           solve_drift_m=f"{drift4:.4f}", vs_one_card_m=f"{d_map:.2e}")
    return len(devices)


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    dev = require_gpu()
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    from rolo_tpu.runtime.platform import enable_compilation_cache, gpu_card_line

    import jax

    print(gpu_card_line(), flush=True)
    cache = enable_compilation_cache()
    _phase("device", t0, kind=repr(dev.device_kind), count=len(jax.devices()),
           matmul_precision=jax.config.jax_default_matmul_precision,
           compile_cache=cache)

    if args.four_cards:
        count = four_cards()
    else:
        phase_kernels()
        phase_registration()
        phase_slam()
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                              "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
