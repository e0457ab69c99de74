"""End-to-end pipeline benchmark: SlamSystem scans/s at the reference
cadences on realistic raycast scans.

Covers what bench.py (front-end registration only) does not: projection,
LOAM features, scan-to-submap GN (the backMapping.cpp:681-1068 hot path),
loop-closure and prior ticks, and the host<->device traffic of the real
driver loop. Reports steady-state scans/s (compile-heavy warmup excluded),
per-stage wall-clock ms, and the front-end registration step's XLA flop
count and isolated device time.

Usage (on the card):
  python tools/bench_pipeline.py [--scans 80] [--warmup 20] [--out BENCH_PIPELINE.json]

The 10 Hz LiDAR design point (src/imageProjection.cpp:79) means
vs_baseline = scans_per_s / 10.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def registration_flops(slam) -> float:
    """XLA-reported flops of one jitted front-end scan_step. Conservative:
    XLA counts only the HLO it keeps after optimization."""
    import jax
    import jax.numpy as jnp

    from rolo_tpu.frontend import odometry

    cfg = slam.cfg
    st = slam.odom_state
    fn = jax.jit(
        lambda state, xyz, mask, dt: odometry.scan_step(
            state, xyz, mask, dt, cfg.registration,
            cfg.static.max_voxels, cfg.registration.k_correspondences,
        )
    )
    n = st.prev_xyz.shape[0]
    lowered = fn.lower(st, jnp.zeros((n, 3), jnp.float32), jnp.ones((n,), bool),
                       jnp.asarray(0.1, jnp.float32))
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    return flops


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--no-priors", action="store_true")
    ap.add_argument("--synced", action="store_true",
                    help="profiling mode: per-stage device-true timing "
                         "(slower end-to-end; stage_ms become meaningful)")
    ap.add_argument("--out", default="BENCH_PIPELINE.json")
    args = ap.parse_args()

    import numpy as np

    from rolo_tpu.runtime.platform import enable_compilation_cache, pin_requested_platform

    pin_requested_platform()
    enable_compilation_cache()

    from rolo_tpu.config import LoopConfig, RoloConfig
    from rolo_tpu.runtime.slam import SlamSystem
    from rolo_tpu.sim import SimConfig, generate_sequence
    from rolo_tpu.sim.dataset import make_scene

    cfg = RoloConfig()
    if args.no_loops:
        cfg = cfg.replace(loop=LoopConfig(enable=False))

    total = args.warmup + args.scans
    sim = SimConfig(n_scans=total, n_cols=args.cols, sensor="velodyne32",
                    period=24.0, roughness=1.0, seed=0)
    scene = make_scene(sim)

    print(f"generating {total} sim scans ...", file=sys.stderr)
    frames = list(generate_sequence(sim, scene))

    if args.no_priors:
        import dataclasses

        cfg = cfg.replace(prior=dataclasses.replace(cfg.prior, enable=False))
    slam = SlamSystem(cfg)
    slam.sync_stages = bool(args.synced)
    # priors run on the self-built LIVE ground map (the reference-faithful
    # frame-consistent path); no external GT map is injected
    use_priors = cfg.prior.enable

    gt = np.stack([f.gt_trans for f in frames])

    # warmup: trigger every cadence branch's compile, including the first
    # graph-solve bucket (otherwise its multi-second compile lands inside
    # the measured window when the first loop/prior factor arrives)
    for f in frames[: args.warmup]:
        slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time)
    from rolo_tpu.mapping import backend as _backend

    slam.backend_state = _backend.solve_graph_host(slam.backend_state, cfg)
    slam.timers.reset()

    t0 = time.perf_counter()
    for f in frames[args.warmup:]:
        slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time)
    elapsed = time.perf_counter() - t0
    scans_per_s = args.scans / elapsed

    # accuracy sanity on the measured window (not a gate — just recorded)
    from rolo_tpu.runtime import metrics
    est = slam.front_positions_np()
    ate = metrics.ate(est, gt[: est.shape[0]])
    kt, kp, _ = slam.keyframe_trajectory()
    stamps = np.asarray([f.stamp for f in frames])
    ia, ib = metrics.associate_by_time(np.asarray(kt), stamps, max_diff=0.05)
    ate_kf = metrics.ate(kp[ia], gt[ib]) if len(ia) >= 3 else None

    # p50 alongside mean: a single jit compile (e.g. the first graph solve
    # bucket) inflates a 30-sample mean by seconds — the median is the
    # steady-state device cost
    stage = {k: {"mean_ms": round(v["mean_ms"], 3), "p50_ms": round(v["p50_ms"], 3),
                 "count": v["count"]}
             for k, v in slam.timers.summary().items()}

    flops = registration_flops(slam)
    # Device-true frontend step time: the stage timer measures DISPATCH
    # under the async driver (sub-ms), so it comes from an amortized
    # isolated re-timing of the jitted scan_step at the run's real shapes.
    import jax

    from rolo_tpu.frontend import odometry as _odo

    _f = frames[-1]
    _scan = slam._make_raw_scan(_f.points, _f.ring, _f.rel_time)
    if True:
        from rolo_tpu.pointcloud.cloud import concat_clouds as _cc

        import jax.numpy as jnp

        if cfg.sensor.deskew_enabled:
            _img = slam._project(
                _scan, jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                jnp.asarray(cfg.sensor.scan_period, jnp.float32),
            )
        else:
            _img = slam._project(_scan)
        _fc = slam._extract(_img)
        _feat = _cc(_fc.corners, _fc.surfaces, cfg.static.max_feature_points)
        _dt = jnp.asarray(0.1, jnp.float32)
        _st = slam.odom_state
        _step = lambda: _odo.scan_step(
            _st, _feat.xyz, _feat.mask, _dt, cfg.registration,
            cfg.static.max_voxels, cfg.registration.k_correspondences)
        jax.block_until_ready(_step())
        _t0 = time.perf_counter()
        _iters = 10
        for _ in range(_iters):
            _out = _step()
        jax.block_until_ready(_out)
        frontend_s = (time.perf_counter() - _t0) / _iters

    out = {
        "metric": "pipeline_scans_per_s",
        "synced_stage_timing": bool(args.synced),
        "value": round(scans_per_s, 2),
        "unit": "scans/s/chip (end-to-end)",
        "vs_baseline": round(scans_per_s / 10.0, 2),
        "n_scans_measured": args.scans,
        "loops_enabled": bool(cfg.loop.enable),
        "priors_enabled": bool(use_priors),
        "stage_mean_ms": stage,
        "ate_frontend_rmse_m": round(ate.rmse, 4),
        "ate_keyframes_rmse_m": round(ate_kf.rmse, 4) if ate_kf else None,
        "frontend_flops_per_step": flops,
        "frontend_device_ms": round(frontend_s * 1e3, 3),
        "drop_counts": slam.drop_counts,
        # accepted factor counts (VERDICT round-3: every recorded run had
        # n_prior_factors=0 — the counts must be first-class bench output)
        "n_keyframes": int(slam.backend_state.db.count),
        "n_loop_factors": int(slam.backend_state.graph.loops.count),
        "n_prior_factors": int(slam.backend_state.graph.priors.count),
    }
    from rolo_tpu.runtime.platform import bench_metadata

    out["machine"] = bench_metadata()
    print(json.dumps(out))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
