"""Benchmark: scan-pair rot-GICP registrations per second on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The reference's real-time design point is 10 Hz per-scan processing on an
8-core CPU (src/imageProjection.cpp:79, config/params.yaml numberOfCores);
vs_baseline is therefore registrations/s divided by 10.

Workload (realistic, not a rotated copy): consecutive raycast-simulated
scans 0.2 s apart from the in-repo LiDAR simulator — a 32-beam sensor on
uneven terrain at ~5 m/s with ~3.6 deg/pair yaw rate, independent range
noise and dropout per scan, motion distortion, partial overlap from
occlusion shift. Features come from the production projection + LOAM
extraction pipeline at the default static capacities (16384 feature slots),
and the initial guess is zero — i.e. >= 0.5 m / several deg initial error,
exactly the regime the front-end faces (stateLinearPropagation zeroes
rotation, src/lidarOdometry.cpp:700-712).

An accuracy gate (median recovered motion vs simulator ground truth) runs
before timing: the throughput number is only printed if the solves actually
register, so the metric cannot improve by silently diverging.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _gt_relative(rot_prev, trans_prev, rot_cur, trans_cur):
    """T_cur^-1 o T_prev: maps prev-scan sensor points into the cur frame —
    the production registration direction (frontend/odometry.py registers
    src=prev features onto tgt=new scan)."""
    rel_rot = rot_cur.T @ rot_prev
    rel_trans = rot_cur.T @ (trans_prev - trans_cur)
    return rel_rot, rel_trans


def _build_pairs(batch: int, stride: int = 2):
    """Raycast `batch` scan pairs and extract features with the production
    pipeline. Returns stacked feature arrays + GT relative motions."""
    import jax
    import jax.numpy as jnp

    from rolo_tpu.config import RoloConfig
    from rolo_tpu.pointcloud.cloud import concat_clouds
    from rolo_tpu.pointcloud.features import extract_features
    from rolo_tpu.pointcloud.projection import RawScan, project_scan
    from rolo_tpu.sim import SimConfig, generate_sequence

    cfg = RoloConfig()
    st = cfg.static
    sim = SimConfig(
        n_scans=batch + stride, n_cols=1024, sensor="velodyne32",
        period=20.0, roughness=1.2, noise_std=0.02, dropout=0.05, seed=0,
    )

    @jax.jit
    def featurize(scan: RawScan):
        img = project_scan(
            scan, cfg.sensor.n_scan, cfg.sensor.horizon_scan,
            cfg.sensor.lidar_min_range, cfg.sensor.lidar_max_range,
            cfg.sensor.downsample_rate,
        )
        fc = extract_features(
            img, cfg.features.edge_threshold, cfg.features.surf_threshold,
            cfg.features.odometry_surf_leaf_size,
            st.max_corner_points, st.max_surf_points,
        )
        return concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)

    feats, rots, transs = [], [], []
    cap = st.max_raw_points
    for frame in generate_sequence(sim):
        m = min(len(frame.points), cap)
        xyz = np.zeros((cap, 3), np.float32)
        ring = np.zeros((cap,), np.int32)
        rel = np.zeros((cap,), np.float32)
        mask = np.zeros((cap,), bool)
        xyz[:m], ring[:m], rel[:m], mask[:m] = (
            frame.points[:m], frame.ring[:m], frame.rel_time[:m], True)
        cloud = featurize(RawScan(jnp.asarray(xyz), jnp.asarray(ring),
                                  jnp.asarray(rel), jnp.asarray(mask)))
        feats.append(cloud)
        rots.append(frame.gt_rot)
        transs.append(frame.gt_trans)

    # src = earlier scan, tgt = later scan (the front-end direction)
    src_xyz = np.stack([np.asarray(feats[i].xyz) for i in range(batch)])
    src_mask = np.stack([np.asarray(feats[i].mask) for i in range(batch)])
    tgt_xyz = np.stack([np.asarray(feats[i + stride].xyz) for i in range(batch)])
    tgt_mask = np.stack([np.asarray(feats[i + stride].mask) for i in range(batch)])
    gt = [_gt_relative(rots[i], transs[i], rots[i + stride], transs[i + stride])
          for i in range(batch)]
    gt_rot = np.stack([g[0] for g in gt])
    gt_trans = np.stack([g[1] for g in gt])
    return src_xyz, src_mask, tgt_xyz, tgt_mask, gt_rot, gt_trans


ROT_GATE_DEG = 0.75
TRANS_GATE_M = 0.030


def rotation_angle_deg(rot_a, rot_b):
    """Angle (deg) of rot_a^T rot_b for [B, 3, 3] batches, from
    |rot_a - rot_b|_F = 2 sqrt(2) sin(angle / 2): unlike arccos of the
    trace, it stays exact at small angles (f32 rounding of the matrices
    alone puts ~0.03 deg of noise into the arccos form)."""
    diff = np.asarray(rot_a, np.float64) - np.asarray(rot_b, np.float64)
    s = np.linalg.norm(diff.reshape(len(diff), 9), axis=1) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.clip(s, 0.0, 1.0)))


def pose_errors(gt_rot, gt_trans, rot, trans):
    """Per-pair rotation error (deg) and translation error (m)."""
    rot_err_deg = rotation_angle_deg(gt_rot, rot)
    trans_err = np.linalg.norm(np.asarray(trans) - gt_trans, axis=1)
    return rot_err_deg, trans_err


def check_accuracy(rot_err_deg, trans_err) -> None:
    """Median-error gate. On an H100 the default pipeline reaches about
    0.043 deg and 0.0101 m median on this workload, so the rotation gate
    sits ~17x above it and the translation gate ~3x: divergence and large
    regressions fail with rc != 0, but a 2x rotation regression (TF32
    matmuls gave 0.083 deg) passes."""
    assert np.median(rot_err_deg) < ROT_GATE_DEG, (
        f"rot accuracy regressed: median {np.median(rot_err_deg):.2f} deg >= {ROT_GATE_DEG}")
    assert np.median(trans_err) < TRANS_GATE_M, (
        f"trans accuracy regressed: median {np.median(trans_err):.3f} m >= {TRANS_GATE_M}")


def batched_registration(batch: int):
    """vmapped production registration over `batch` scan pairs:
    (src, src_mask, tgt, tgt_mask, guess, last, dt) -> ScanPairResult."""
    import jax

    from rolo_tpu.config import RegistrationConfig, RoloConfig
    from rolo_tpu.registration.rotgicp import register_scan_pair

    cfg = RegistrationConfig()
    voxel_capacity = RoloConfig().static.max_voxels
    k = cfg.k_correspondences
    return jax.vmap(
        lambda s, sm, t, tm, g, l, d: register_scan_pair(
            s, sm, t, tm, g, l, d, d, cfg, voxel_capacity, k
        )
    )


def registrations_per_s(one, src, src_mask, tgt, tgt_mask, dt, iters: int = 10) -> float:
    """Steady-state registrations/s of `one` (batched_registration) with
    `iters` dependent batches chained inside one program: a production
    deployment keeps the loop on device, so no per-call host round trip is
    billed against the chip. The 1e-6-scaled feedback keeps a data
    dependency between iterations while leaving every solve at the
    zero-guess difficulty."""
    import jax
    import jax.numpy as jnp

    batch = src.shape[0]

    @jax.jit
    def chained(src, src_mask, tgt, tgt_mask, dt):
        def body(carry, _):
            g = carry
            res = one(src, src_mask, tgt, tgt_mask, g, jnp.zeros_like(g), dt)
            return res.trans * 1e-6, res.rot_error
        _, errs = jax.lax.scan(body, jnp.zeros((batch, 3)), None, length=iters)
        return errs

    jax.block_until_ready(chained(src, src_mask, tgt, tgt_mask, dt))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(chained(src, src_mask, tgt, tgt_mask, dt))
    return batch * iters / (time.perf_counter() - t0)


def main():
    import jax
    import jax.numpy as jnp

    from rolo_tpu.runtime.platform import bench_metadata, enable_compilation_cache

    enable_compilation_cache()
    machine = bench_metadata()
    print(f"machine: {json.dumps(machine)}", file=sys.stderr)

    batch = int(os.environ.get("ROLO_BENCH_BATCH", "16"))
    t_gen = time.perf_counter()
    src, src_mask, tgt, tgt_mask, gt_rot, gt_trans = _build_pairs(batch)
    print(f"workload: {batch} sim scan pairs, "
          f"median |gt_trans|={np.median(np.linalg.norm(gt_trans, axis=1)):.2f} m, "
          f"gen {time.perf_counter() - t_gen:.1f}s", file=sys.stderr)

    src, tgt, src_mask, tgt_mask = (jnp.asarray(a) for a in (src, tgt, src_mask, tgt_mask))
    dt = jnp.full((batch,), 0.2, jnp.float32)
    one = batched_registration(batch)

    # Accuracy gate: zero-guess solves must recover the simulated motion.
    res = jax.jit(one)(src, src_mask, tgt, tgt_mask,
                       jnp.zeros((batch, 3)), jnp.zeros((batch, 3)), dt)
    rot_err_deg, trans_err = pose_errors(gt_rot, gt_trans, res.rot, res.trans)
    print(f"accuracy: rot_err median {np.median(rot_err_deg):.2f} deg, "
          f"trans_err median {np.median(trans_err):.3f} m", file=sys.stderr)
    check_accuracy(rot_err_deg, trans_err)

    regs_per_s = registrations_per_s(one, src, src_mask, tgt, tgt_mask, dt)
    print(
        json.dumps(
            {
                "metric": "scan_registrations_per_s",
                "value": round(regs_per_s, 2),
                "unit": "registrations/s/chip",
                "vs_baseline": round(regs_per_s / 10.0, 2),
                "machine": machine,
            }
        )
    )


if __name__ == "__main__":
    main()
