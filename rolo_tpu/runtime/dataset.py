"""End-to-end dataset harness: run SlamSystem over a scan source, export
trajectories, and score ATE/RPE against ground truth.

This is the automated version of the reference's manual evaluation loop —
`roslaunch` + `rosbag play` + TUM export + external evo scoring
(/root/reference/README.md:44-52, src/backMapping.cpp:2679-2699; SURVEY.md
section 4). Scan sources: the in-repo simulator (exact GT), a directory of
KITTI .bin or PCD files (GT from a TUM file), or a rosbag v2.

The reference C++ cannot be executed here (no ROS in this environment), so
dataset/simulator ground truth is the accuracy oracle, per BASELINE.md.
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import RoloConfig
from . import io as rio
from . import metrics
from .slam import SlamSystem


@dataclass
class SequenceResult:
    n_scans: int = 0
    wall_s: float = 0.0
    scans_per_s: float = 0.0
    # ATE of the front-end (per-scan) and optimized keyframe trajectories
    ate_frontend: Optional[metrics.ATEResult] = None
    ate_keyframes: Optional[metrics.ATEResult] = None
    rpe_frontend: Optional[float] = None
    drop_counts: Dict[str, int] = field(default_factory=dict)
    stage_ms: Dict[str, float] = field(default_factory=dict)
    # factor-graph evidence (backMapping addLoopFactor/addPriorFactor
    # analogs): how many loop / prior factors were actually ACCEPTED — the
    # round-2 A/B could not show loops mattering because it never recorded
    # whether any fired (VERDICT round-2 missing item 1)
    n_keyframes: int = 0
    n_loop_factors: int = 0
    n_prior_factors: int = 0
    ate_keyframes_z_rmse: Optional[float] = None
    # roll/pitch RMSE (rad) of the optimized keyframe attitudes vs GT —
    # with z_rmse, the metric the ground-prior subsystem exists to improve
    # (the ROLO paper's uneven-terrain claim)
    ate_keyframes_rp_rmse: Optional[float] = None
    # host wall time of each process_scan call (s); the first includes
    # compiling the per-scan programs
    scan_s: List[float] = field(default_factory=list)

    def to_json(self) -> dict:
        out = {
            "n_scans": self.n_scans,
            "wall_s": round(self.wall_s, 3),
            "scans_per_s": round(self.scans_per_s, 2),
            "drop_counts": self.drop_counts,
            "stage_ms": {k: round(v, 3) for k, v in self.stage_ms.items()},
            "n_keyframes": self.n_keyframes,
            "n_loop_factors": self.n_loop_factors,
            "n_prior_factors": self.n_prior_factors,
        }
        if self.scan_s:
            steady_ms = np.asarray(self.scan_s[1:] or self.scan_s) * 1e3
            out["first_scan_s"] = round(self.scan_s[0], 3)
            out["scan_ms_p50"] = round(float(np.percentile(steady_ms, 50)), 3)
            out["scan_ms_p99"] = round(float(np.percentile(steady_ms, 99)), 3)
        if self.ate_frontend is not None:
            out["ate_frontend_rmse_m"] = round(self.ate_frontend.rmse, 4)
        if self.ate_keyframes is not None:
            out["ate_keyframes_rmse_m"] = round(self.ate_keyframes.rmse, 4)
        if self.ate_keyframes_z_rmse is not None:
            out["ate_keyframes_z_rmse_m"] = round(self.ate_keyframes_z_rmse, 4)
        if self.ate_keyframes_rp_rmse is not None:
            out["ate_keyframes_rp_rmse_rad"] = round(self.ate_keyframes_rp_rmse, 5)
        if self.rpe_frontend is not None:
            out["rpe_frontend_rmse_m"] = round(self.rpe_frontend, 4)
        return out


def run_frames(
    slam: SlamSystem,
    frames: Iterable,
    gt: Optional[List[Tuple[float, np.ndarray]]] = None,
    out_dir: Optional[str] = None,
    progress_every: int = 0,
) -> SequenceResult:
    """Drive `slam` over frames. Each frame needs .stamp/.points and may
    carry .ring/.rel_time/.gt_trans (simulator frames do). `gt` optionally
    supplies (stamp, position) ground truth for non-sim sources."""
    gt_times: List[float] = []
    gt_pos: List[np.ndarray] = []
    if gt:
        gt_times = [t for t, _ in gt]
        gt_pos = [p for _, p in gt]

    n = 0
    t_start = time.perf_counter()
    gt_rots: List[np.ndarray] = []
    scan_s: List[float] = []
    for frame in frames:
        ring = getattr(frame, "ring", None)
        rel_time = getattr(frame, "rel_time", None)
        t_scan = time.perf_counter()
        slam.process_scan(frame.points, frame.stamp, ring=ring, rel_time=rel_time)
        scan_s.append(time.perf_counter() - t_scan)
        if getattr(frame, "gt_trans", None) is not None and not gt:
            gt_times.append(frame.stamp)
            gt_pos.append(np.asarray(frame.gt_trans))
            if getattr(frame, "gt_rot", None) is not None:
                gt_rots.append(np.asarray(frame.gt_rot))
        n += 1
        if progress_every and n % progress_every == 0:
            print(f"  scan {n} ({time.perf_counter() - t_start:.1f}s)", flush=True)
    wall = time.perf_counter() - t_start
    # flush the deferred graph solve + final capacity check BEFORE reading
    # counts/poses (ADVICE round-3: loop corrections near trajectory end
    # were silently dropped, and short runs never hit the capacity cadence)
    slam.finalize()

    res = SequenceResult(
        n_scans=n, wall_s=wall, scans_per_s=n / max(wall, 1e-9),
        drop_counts=dict(slam.drop_counts),
        stage_ms={k: v["mean_ms"] for k, v in slam.timers.summary().items()},
        n_keyframes=int(slam.backend_state.db.count),
        n_loop_factors=int(slam.backend_state.graph.loops.count),
        n_prior_factors=int(slam.backend_state.graph.priors.count),
        scan_s=scan_s,
    )

    if gt_pos:
        gt_t = np.asarray(gt_times)
        gt_p = np.asarray(gt_pos)
        # SlamSystem rebases stamps to the first scan
        est_t = np.asarray(slam.times) + (slam._epoch or 0.0)
        est_p = slam.front_positions_np()
        ia, ib = metrics.associate_by_time(est_t, gt_t, max_diff=0.05)
        if len(ia) >= 3:
            res.ate_frontend = metrics.ate(est_p[ia], gt_p[ib])
            res.rpe_frontend = metrics.rpe(est_p[ia], gt_p[ib])
        kt, kp, kq = slam.keyframe_trajectory()
        ia, ib = metrics.associate_by_time(np.asarray(kt) + (slam._epoch or 0.0), gt_t, max_diff=0.05)
        if len(ia) >= 3:
            res.ate_keyframes = metrics.ate(kp[ia], gt_p[ib])
            # z-only residual after the same SE(3) Umeyama alignment ATE
            # uses (slam's world frame is the first sensor pose, gt's is
            # the sim world): the elevation-accuracy claim the prior stack
            # exists to improve (ROLO paper / prior_pose_node)
            if kp[ia].shape[0] >= 3:
                rot_a, trans_a, _ = metrics.umeyama_alignment(kp[ia], gt_p[ib])
                est_aligned = kp[ia] @ rot_a.T + trans_a
                res.ate_keyframes_z_rmse = float(
                    np.sqrt(np.mean((est_aligned[:, 2] - gt_p[ib][:, 2]) ** 2))
                )
                if gt_rots and kq.shape[0] == kp.shape[0]:
                    # attitude residual after the SAME alignment: roll/pitch
                    # of R_gt^T (R_align R_est) per keyframe
                    import jax
                    import jax.numpy as _jnp

                    from ..geometry import so3 as _so3

                    r_est = np.asarray(
                        jax.vmap(_so3.quat_to_matrix)(_jnp.asarray(kq[ia]))
                    )
                    r_gt = np.stack([gt_rots[j] for j in ib])
                    rel = np.einsum("nji,njk->nik", r_gt, rot_a[None] @ r_est)
                    roll = np.arctan2(rel[:, 2, 1], rel[:, 2, 2])
                    pitch = np.arcsin(np.clip(-rel[:, 2, 0], -1.0, 1.0))
                    res.ate_keyframes_rp_rmse = float(
                        np.sqrt(np.mean(roll**2 + pitch**2))
                    )

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_results(out_dir)
        if gt_pos:
            quats = np.tile(np.array([1.0, 0, 0, 0]), (len(gt_pos), 1))
            rio.write_tum(os.path.join(out_dir, "gt_tum.txt"), gt_times, np.asarray(gt_pos), quats)
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(res.to_json(), f, indent=2)
    return res


# ---------------------------------------------------------------------------
# Scan sources
# ---------------------------------------------------------------------------


class _Frame:
    __slots__ = ("stamp", "points", "ring", "rel_time", "gt_trans")

    def __init__(self, stamp, points, ring=None, rel_time=None, gt_trans=None):
        self.stamp = stamp
        self.points = points
        self.ring = ring
        self.rel_time = rel_time
        self.gt_trans = gt_trans


def frames_from_dir(path: str, rate_hz: float = 10.0) -> Iterator[_Frame]:
    """KITTI .bin or PCD directory, sorted by filename; stamps synthesized
    at `rate_hz` when filenames are not timestamps."""
    files = sorted(glob.glob(os.path.join(path, "*.bin")) + glob.glob(os.path.join(path, "*.pcd")))
    if not files:
        raise FileNotFoundError(f"no .bin/.pcd scans under {path}")
    for i, fp in enumerate(files):
        if fp.endswith(".bin"):
            pts = rio.read_kitti_bin(fp)[:, :3]
            ring = None
            rel = None
        else:
            fields = rio.read_pcd(fp)
            pts = np.column_stack([fields["x"], fields["y"], fields["z"]]).astype(np.float32)
            ring = fields.get("ring")
            rel = fields.get("time", fields.get("t"))
            if rel is not None and rel.dtype.kind in "ui":  # Ouster t: nanoseconds
                rel = (rel.astype(np.float64) * 1e-9).astype(np.float32)
        stem = os.path.splitext(os.path.basename(fp))[0]
        # Filenames are timestamps only when they look like seconds
        # (fractional part or epoch-length digits); KITTI-style frame
        # indices ("000001") must fall through to synthesized stamps,
        # else intervals come out 10x wrong and break CT scaling.
        if "." in stem or len(stem.lstrip("0") or "0") >= 10:
            try:
                stamp = float(stem)
            except ValueError:
                stamp = i / rate_hz
        else:
            stamp = i / rate_hz
        yield _Frame(stamp, pts, ring=ring, rel_time=rel)


def frames_from_bag(path: str, topic: Optional[str] = None) -> Iterator[_Frame]:
    """PointCloud2 messages from a rosbag v2 via the native host reader."""
    from ..cpp import host

    reader = host.BagReader(path)
    conns = reader.connections
    pc2 = [c for c, typ in conns if "PointCloud2" in typ]
    want = topic or (pc2[0] if pc2 else None)
    if want is None:
        raise ValueError(f"no PointCloud2 topics in {path}: {conns}")
    for i in range(len(reader)):
        conn_idx, stamp, _ = reader.message_info(i)
        cname, ctype = conns[conn_idx]
        if cname != want:
            continue
        fields = reader.read_pointcloud2(i)
        pts = np.asarray(fields["xyz"], np.float32)
        ring = fields.get("ring")
        rel = fields.get("time")
        if rel is not None and rel.dtype.kind in "ui":
            rel = (rel.astype(np.float64) * 1e-9).astype(np.float32)
        # the PointCloud2 header stamp (inside the message) is the scan
        # time; fall back to the bag record time when it is zero
        stamp = fields.get("stamp", 0.0) or stamp
        yield _Frame(stamp, pts, ring=ring, rel_time=rel)


def gt_from_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    t, pos, _ = rio.read_tum(path)
    return list(zip(t.tolist(), pos))


def run_simulated(
    cfg: RoloConfig,
    sim_cfg=None,
    out_dir: Optional[str] = None,
    with_priors: bool = True,
    progress_every: int = 0,
    ground_source: str = "live",
) -> SequenceResult:
    """Full pipeline over a simulated sequence (rolo_tpu.sim): scans,
    ground input for the prior stack, ATE vs exact GT.

    ground_source: "live" (default) lets the system build its own ground
    map from segmented scans — the reference-faithful architecture, where
    the /voxel_map producer runs in the SAME drifting odom frame as the
    estimate; "external" injects the simulator's exact GT ground map, which
    is frame-INCONSISTENT with a drifting estimate (the prior patch ICP
    then measures GT-vs-estimate offset instead of drift) — useful only
    for gate/solver plumbing tests."""
    from ..sim import SimConfig, generate_sequence, ground_map_points
    from ..sim.dataset import make_scene

    import dataclasses

    from ..sim import SimConfig as _SimConfig  # noqa: F401

    sim_cfg = sim_cfg or SimConfig()
    scene = make_scene(sim_cfg)
    if not with_priors and cfg.prior.enable:
        # the live ground path makes priors self-sufficient, so "no priors"
        # must disable the subsystem, not merely withhold the external map
        cfg = cfg.replace(prior=dataclasses.replace(cfg.prior, enable=False))
    slam = SlamSystem(cfg)
    if with_priors and cfg.prior.enable and ground_source == "external":
        slam.set_ground_map(ground_map_points(sim_cfg, scene))
    return run_frames(
        slam, generate_sequence(sim_cfg, scene), out_dir=out_dir,
        progress_every=progress_every,
    )
