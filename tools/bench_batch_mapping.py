"""Batched-mapping throughput: BASELINE config 5 on one chip.

The pod-scale north star is "thousands of concurrent scan registrations +
multi-sequence pose graphs" (SURVEY 2.7 last row). dryrun_multichip
phase 3 proves the sharded program COMPILES and tracks poses on a virtual
mesh; this bench measures the real per-chip THROUGHPUT of that exact
workload: B independent sequences' full backend_step (submap extraction,
scan-to-submap GN, keyframe gating, odometry factors) vmapped into one
device program, stepped K times with a lax.scan (states feed forward, so
the measurement is device-resident like bench.py), then a vmapped dense
pose-graph solve over all B graphs. Pose-checked before timing.

Writes BENCH_BATCH_MAPPING.json. Usage (on the card):
python tools/bench_batch_mapping.py [--batch 16] [--steps 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _world(seed, n_surf, n_corner):
    rng = np.random.default_rng(seed)
    walls = []
    for nv, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0, 0, 1), -1.5),
                  ((0.7, 0.7, 0), 12.0)]:
        m = n_surf // 4
        nv = np.array(nv, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0] if abs(nv[2]) < 0.9 else [1.0, 0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        u = rng.uniform(-7, 7, (m, 2))
        walls.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    surf = np.concatenate(walls)[:n_surf].astype(np.float32)
    surf += rng.normal(0, 0.005, surf.shape).astype(np.float32)
    pts = []
    for px, py in [(4.0, 2.0), (6.0, -3.0), (9.0, 1.0), (3.0, -1.5),
                   (7.5, 3.5), (2.0, 0.5)]:
        m = n_corner // 6
        z = rng.uniform(-1.0, 2.0, (m, 1))
        pts.append(np.concatenate(
            [np.full((m, 1), px), np.full((m, 1), py), z], axis=1))
    corner = np.concatenate(pts)[:n_corner].astype(np.float32)
    corner += rng.normal(0, 0.005, corner.shape).astype(np.float32)
    return corner, surf


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", default="BENCH_BATCH_MAPPING.json")
    args = ap.parse_args()

    from rolo_tpu.runtime.platform import (
        bench_metadata, enable_compilation_cache, pin_requested_platform,
    )

    pin_requested_platform()
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from rolo_tpu.config import (
        LoopConfig, MappingConfig, RoloConfig, StaticConfig,
    )
    from rolo_tpu.graph.solver import solve_pose_graph
    from rolo_tpu.mapping import backend as mb
    from rolo_tpu.pointcloud.cloud import PaddedCloud

    cfg = RoloConfig(
        mapping=MappingConfig(scan2map_max_iterations=8),
        loop=LoopConfig(enable=False),
        static=StaticConfig(
            max_raw_points=8192, max_corner_points=1024, max_surf_points=4096,
            max_feature_points=5120, max_voxels=4096, max_keyframes=32,
            max_submap_points=8192, max_loop_factors=8, max_prior_factors=8,
            knn_query_chunk=512,
        ),
    )
    st = cfg.static
    B, K = args.batch, args.steps

    # per-sequence worlds + trajectories (sequence b advances along x)
    gt = np.zeros((B, K, 3), np.float32)
    corners = np.zeros((K, B, st.max_corner_points, 3), np.float32)
    cmask = np.zeros((K, B, st.max_corner_points), bool)
    surfs = np.zeros((K, B, st.max_surf_points, 3), np.float32)
    smask = np.zeros((K, B, st.max_surf_points), bool)
    for b in range(B):
        cw, sw = _world(100 + b, st.max_surf_points, st.max_corner_points)
        for s in range(K):
            gt[b, s, 0] = (0.8 + 0.03 * b) * s
            corners[s, b, : len(cw)] = cw - gt[b, s]
            cmask[s, b, : len(cw)] = True
            surfs[s, b, : len(sw)] = sw - gt[b, s]
            smask[s, b, : len(sw)] = True

    noise = np.random.default_rng(0).normal(0, 0.02, (K, B, 3)).astype(np.float32)
    noise[0] = 0.0
    guesses = jnp.asarray(gt.transpose(1, 0, 2) + noise)
    eye = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
    times = jnp.asarray(np.arange(K, dtype=np.float32)[:, None].repeat(B, 1) * 0.5)

    states0 = jtu.tree_map(
        lambda *xs: jnp.stack(xs), *[mb.init_backend(cfg) for _ in range(B)]
    )

    step_v = jax.vmap(
        lambda s, c, cm, f, fm, tr, t: mb.backend_step(
            s, PaddedCloud(c, cm), PaddedCloud(f, fm), PaddedCloud(f, fm),
            eye[0], tr, jnp.asarray(True), t, cfg,
        ),
    )

    @jax.jit
    def run_all(states, corners, cmask, surfs, smask, guesses, times):
        def body(states, inp):
            c, cm, f, fm, g, t = inp
            states, out = step_v(states, c, cm, f, fm, g, t)
            return states, out.trans
        states, poses = jax.lax.scan(
            body, states, (corners, cmask, surfs, smask, guesses, times))
        return states, poses

    cj = jnp.asarray(corners); cmj = jnp.asarray(cmask)
    sj = jnp.asarray(surfs); smj = jnp.asarray(smask)

    # accuracy gate
    states, poses = run_all(states0, cj, cmj, sj, smj, guesses, times)
    jax.block_until_ready(poses)
    kf = np.asarray(states.db.trans)[:, :K]
    err = np.linalg.norm(kf - gt, axis=2)
    counts = np.asarray(states.db.count)
    print(f"accuracy: kf_err max {err.max():.3f} m, counts {counts.min()}-{counts.max()}",
          file=sys.stderr)
    assert (counts == K).all(), counts
    assert err.max() < 0.25, err.max()

    t0 = time.perf_counter()
    for _ in range(args.reps):
        states, poses = run_all(states0, cj, cmj, sj, smj, guesses, times)
        jax.block_until_ready(poses)
    dt = (time.perf_counter() - t0) / args.reps
    mapped_per_s = B * K / dt

    # vmapped pose-graph solve throughput over the B graphs
    solve_v = jax.jit(jax.vmap(
        lambda g, r, t, c: solve_pose_graph(g, r, t, c, method="dense").trans))
    jax.block_until_ready(solve_v(states.graph, states.db.rot, states.db.trans,
                                  states.db.count))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        jax.block_until_ready(solve_v(states.graph, states.db.rot,
                                      states.db.trans, states.db.count))
    dt_solve = (time.perf_counter() - t0) / args.reps
    solves_per_s = B / dt_solve

    report = {
        "metric": "batched_mapping_scans_per_s",
        "value": round(mapped_per_s, 1),
        "unit": "mapped scans/s/chip (full backend_step, B sequences vmapped)",
        "batch_sequences": B,
        "steps_per_sequence": K,
        "graph_solves_per_s": round(solves_per_s, 1),
        "keyframe_err_max_m": round(float(err.max()), 4),
        "capacities": {"corner": st.max_corner_points, "surf": st.max_surf_points,
                       "submap": st.max_submap_points, "keyframes": st.max_keyframes},
        "machine": bench_metadata(),
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: report[k] for k in
                      ("metric", "value", "unit", "graph_solves_per_s")}))
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
