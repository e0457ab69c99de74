"""Scan-to-pose LATENCY benchmark (VERDICT r4 item 4).

The reference's 10 Hz design point (scanPeriod = 0.1 s,
/root/reference/src/imageProjection.cpp:79) is a *latency* statement: the
pose for scan t must be host-readable <= 100 ms after the scan arrives.
BENCH_PIPELINE.json only ever proved throughput (dispatch-ahead scans/s);
this harness measures, per scan, the wall time from scan availability to
the FUSED pose being a host numpy value (and the mapped pose on mapping
scans), with loops + priors + graph solves on — the full production
pipeline in per-scan-synchronous (real-time consumer) mode. Two feed
modes are measured in one run: the 10 Hz sensor-cadence mode (the design
point — background-cadence device work absorbs into inter-arrival gaps,
as the reference's detached threads do) and a saturated back-to-back
stress mode that upper-bounds burst backlog.

Also reports the synced device time of `solve_graph_host` at each
capacity bucket (256/512/1024/2048), bounding how stale a loop correction
can be at any graph size.

Writes BENCH_LATENCY.json. Usage (on the card): python tools/bench_latency.py
[--scans 300] [--cols 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _percentiles(xs):
    a = np.asarray(xs, np.float64) * 1000.0
    return {
        "n": int(a.size),
        "p50_ms": round(float(np.percentile(a, 50)), 2),
        "p95_ms": round(float(np.percentile(a, 95)), 2),
        "p99_ms": round(float(np.percentile(a, 99)), 2),
        "max_ms": round(float(a.max()), 2),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=300)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--period", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_LATENCY.json")
    args = ap.parse_args()

    from rolo_tpu.runtime.platform import (
        bench_metadata, enable_compilation_cache, pin_requested_platform,
    )

    pin_requested_platform()
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from rolo_tpu.config import RoloConfig
    from rolo_tpu.runtime.slam import SlamSystem
    from rolo_tpu.sim import SimConfig, generate_sequence
    from rolo_tpu.sim.dataset import make_scene

    sim = SimConfig(n_scans=args.scans, n_cols=args.cols, sensor="velodyne32",
                    period=args.period, seed=args.seed, roughness=1.0,
                    noise_std=0.02, dropout=0.05, n_boxes=14, n_cyls=24)
    scene = make_scene(sim)
    cfg = RoloConfig()
    slam = SlamSystem(cfg)

    frames = list(generate_sequence(sim, scene))

    # Warm pass: drive the whole sequence once with a throwaway system so
    # every program — including the graph-solve capacity buckets that
    # first fire mid-sequence — is compiled (persistent cache) before the
    # measured pass. Without this, p99 reads compile events (~1-30 s),
    # not steady-state latency; a deployment would precompile the same
    # way (or ship the compilation cache).
    print("warm pass (compiles all programs incl. solve buckets)...",
          file=sys.stderr)
    warm = SlamSystem(cfg)
    for frame in frames:
        out = warm.process_scan(frame.points, frame.stamp,
                                ring=getattr(frame, "ring", None),
                                rel_time=getattr(frame, "rel_time", None))
    warm.finalize()
    del warm

    WARMUP = 20

    def drive(slam, realtime_period=None):
        """Drive the sequence, fetching the published pose per scan.

        realtime_period=None: saturated feed — scan i+1 enters the moment
        scan i's pose is read (a stress mode: every deferred background
        program lands on the next scan's critical path).
        realtime_period=T: scans ARRIVE at the sensor cadence (the 10 Hz
        design point, /root/reference/src/imageProjection.cpp:79); latency
        is measured from arrival to the pose being a host value, and
        background-cadence device work (loop verify / prior / graph solve)
        absorbs into the inter-arrival idle gap exactly as the reference's
        detached threads do. If processing falls behind the stream, the
        backlog shows up in the latency numbers — nothing is excluded.
        The first WARMUP scans run unpaced (they carry per-instance
        retrace/cache-lookup cost that a resident deployment pays once at
        startup, before the sensor stream starts) and the arrival clock is
        anchored when they complete, so the measured region starts with a
        drained pipeline rather than a startup backlog."""
        lat_all, lat_map, lat_plain = [], [], []
        spikes = []
        prev_solves = prev_loops = 0
        gt_pos, est_pos = [], []
        t_run0 = time.perf_counter()
        start = None
        for i, frame in enumerate(frames):
            if realtime_period is not None and i >= WARMUP:
                if start is None:
                    start = time.perf_counter()
                arrival = start + (i - WARMUP) * realtime_period
                now = time.perf_counter()
                if now < arrival:
                    time.sleep(arrival - now)
                t0 = arrival
            else:
                t0 = time.perf_counter()
            out = slam.process_scan(frame.points, frame.stamp,
                                    ring=getattr(frame, "ring", None),
                                    rel_time=getattr(frame, "rel_time", None))
            # the real-time consumer contract: the fused pose (and the
            # mapped pose on mapping scans) as host values, this scan, now
            # — batched into ONE device->host transfer (each separate
            # np.asarray pays a device round trip)
            if "mapped_trans" in out:
                pose = np.asarray(jnp.concatenate([out["fused_trans"],
                                                   out["mapped_trans"]]))
                fused, mapped = pose[:3], pose[3:]
            else:
                fused = np.asarray(out["fused_trans"])
            dt = time.perf_counter() - t0
            if i >= 20:  # exclude warmup/compile scans from the statistics
                lat_all.append(dt)
                (lat_map if "mapped_trans" in out else lat_plain).append(dt)
                if dt > 0.5:
                    n_solves = len(slam.timers._samples.get("graph_solve", ()))
                    n_loops = len(slam.timers._samples.get("loop_closure", ()))
                    spikes.append({
                        "scan": i, "ms": round(dt * 1000, 1),
                        "mapping": "mapped_trans" in out,
                        "solve_fired": n_solves > prev_solves,
                        "loop_fired": n_loops > prev_loops,
                    })
            prev_solves = len(slam.timers._samples.get("graph_solve", ()))
            prev_loops = len(slam.timers._samples.get("loop_closure", ()))
            est_pos.append(np.asarray(out["mapped_trans"])
                           if "mapped_trans" in out else fused)
            gt_pos.append(np.asarray(frame.gt_trans))
        wall = time.perf_counter() - t_run0
        slam.finalize()
        return lat_all, lat_map, lat_plain, spikes, gt_pos, est_pos, wall

    print(f"driving {len(frames)} scans, saturated feed (stress mode)",
          file=sys.stderr)
    lat_all, lat_map, lat_plain, spikes, gt_pos, est_pos, wall = drive(slam)

    period = cfg.sensor.scan_period
    print(f"driving {len(frames)} scans at the {1.0 / period:.0f} Hz sensor "
          f"arrival cadence (design-point mode)", file=sys.stderr)
    rt = drive(SlamSystem(cfg), realtime_period=period)
    rt_all, rt_map, rt_plain, rt_spikes = rt[0], rt[1], rt[2], rt[3]

    # sanity: the run must actually have tracked (Umeyama-aligned ATE,
    # same convention as runtime/dataset.py)
    from rolo_tpu.runtime import metrics

    a = metrics.ate(np.stack(est_pos), np.stack(gt_pos))
    drift = a.rmse
    print(f"ATE rmse: {drift:.3f} m", file=sys.stderr)

    budget_ms = cfg.sensor.scan_period * 1000.0
    report = {
        "description": __doc__.split("\n")[0],
        "workload": {
            "n_scans": len(frames), "n_cols": args.cols,
            "loops": cfg.loop.enable, "priors": cfg.prior.enable,
            "deskew": cfg.sensor.deskew_enabled,
            "warmup_scans_excluded": 20,
        },
        # Design-point measurement: scans arrive at the sensor cadence
        # (10 Hz); latency = arrival -> pose host-readable. This is the
        # reference's real-time contract (scanPeriod=0.1 s) and the basis
        # for the meets_10hz_budget_* verdicts below.
        "scan_to_pose_latency_realtime_10hz": {
            "all": _percentiles(rt_all),
            "mapping_scans": _percentiles(rt_map) if rt_map else None,
            "non_mapping_scans": _percentiles(rt_plain) if rt_plain else None,
        },
        # Stress measurement: saturated feed, scan i+1 enters the moment
        # scan i's pose is read — every background program (loop verify,
        # prior cycle, graph solve) lands on the NEXT scan's critical path
        # instead of the inter-arrival gap. Upper-bounds the backlog a
        # burst of late scans could create.
        "scan_to_pose_latency_saturated": {
            "all": _percentiles(lat_all),
            "mapping_scans": _percentiles(lat_map) if lat_map else None,
            "non_mapping_scans": _percentiles(lat_plain) if lat_plain else None,
        },
        "budget_ms": budget_ms,
        "meets_10hz_budget_p99_wall": bool(
            np.percentile(np.asarray(rt_all) * 1000, 99) <= budget_ms),
        "synced_wall_scans_per_s": round(len(frames) / wall, 2),
        "ate_rmse_m": round(drift, 4),
    }

    # ---- graph-solve device time per capacity bucket --------------------
    from rolo_tpu.mapping import backend as mb

    state = slam.backend_state
    cap = state.db.capacity
    bucket_ms = {}
    for bucket in (256, 512, 1024, 2048):
        if bucket > cap:
            continue
        # count_hint pins the bucket; db.count masks the real rows, so the
        # timing reflects a graph solve AT that bucket size
        s2 = mb.solve_graph_host(state, cfg, count_hint=bucket)
        jax.block_until_ready(s2.db.rot)  # compile
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            s2 = mb.solve_graph_host(state, cfg, count_hint=bucket)
            jax.block_until_ready(s2.db.rot)
        bucket_ms[str(bucket)] = round((time.perf_counter() - t0) / reps * 1000, 1)
    report["latency_spikes_over_500ms"] = {
        "realtime": rt_spikes, "saturated": spikes,
    }
    report["graph_solve_synced_ms_by_bucket"] = bucket_ms
    report["machine"] = bench_metadata()

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["scan_to_pose_latency_realtime_10hz"]["all"]))
    print(f"graph solve ms by bucket: {bucket_ms}", file=sys.stderr)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
