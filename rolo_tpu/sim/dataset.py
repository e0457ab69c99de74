"""Sequence generation: drive the simulated vehicle and emit scans + exact
ground truth — the in-repo replacement for the reference's bag-replay
system test (/root/reference/README.md:44-52; the 8.9 GB bag is an external
download).

`generate_sequence` is host-facing: it returns numpy scans shaped like real
sensor output (points + ring + per-point relative time) and the ground-truth
sensor pose at each scan stamp, for ATE scoring against the TUM export
(backMapping.cpp:2679-2699).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .lidar import LidarModel, simulate_scan, velodyne16, velodyne32
from .scene import Scene, default_scene, loop_trajectory_pose, terrain_height


@dataclass(frozen=True)
class SimConfig:
    seed: int = 0
    n_scans: int = 120
    scan_rate_hz: float = 10.0
    n_cols: int = 1024
    sensor: str = "velodyne32"  # velodyne32 | velodyne16
    # trajectory (one loop-closing revisit per `period` seconds)
    radius_x: float = 18.0
    radius_y: float = 14.0
    period: float = 60.0
    sensor_height: float = 1.8
    # world
    extent: float = 60.0
    roughness: float = 1.0
    n_boxes: int = 14
    n_cyls: int = 24
    # sensor noise
    noise_std: float = 0.02
    dropout: float = 0.05
    max_range: float = 100.0
    # False raycasts every column from the sweep-start pose (no motion
    # distortion) — the control condition for deskew/accuracy studies
    motion_distortion: bool = True


class SimFrame(NamedTuple):
    stamp: float
    points: np.ndarray  # [N, 3] sensor frame
    ring: np.ndarray  # [N] int32
    rel_time: np.ndarray  # [N] float32
    gt_rot: np.ndarray  # [3, 3] sensor pose in world at `stamp`
    gt_trans: np.ndarray  # [3]


def _model(cfg: SimConfig) -> LidarModel:
    if cfg.sensor == "velodyne16":
        return velodyne16(max_range=cfg.max_range, noise_std=cfg.noise_std, dropout=cfg.dropout)
    return velodyne32(max_range=cfg.max_range, noise_std=cfg.noise_std, dropout=cfg.dropout)


def make_scene(cfg: SimConfig) -> Scene:
    return default_scene(seed=cfg.seed, extent=cfg.extent, n_boxes=cfg.n_boxes,
                         n_cyls=cfg.n_cyls, roughness=cfg.roughness)


def generate_sequence(cfg: SimConfig, scene: Optional[Scene] = None) -> Iterator[SimFrame]:
    """Yield scans at `scan_rate_hz`. Each scan's columns are raycast from
    the sensor pose at their own capture time (motion distortion); the
    reported ground truth is the pose at sweep start.

    The whole per-scan computation (trajectory sampling + raycast + noise)
    is ONE jitted program: per-op eager dispatch latency would otherwise
    dominate generation."""
    scene = make_scene(cfg) if scene is None else scene
    model = _model(cfg)
    period_s = 1.0 / cfg.scan_rate_hz
    col_frac = jnp.arange(cfg.n_cols) / cfg.n_cols

    @jax.jit
    def one_scan(t0, key):
        traj = lambda t: loop_trajectory_pose(
            scene, t, radius_x=cfg.radius_x, radius_y=cfg.radius_y,
            period=cfg.period, sensor_height=cfg.sensor_height,
        )
        col_times = t0 + col_frac * period_s
        if cfg.motion_distortion:
            col_rot, col_trans = traj(col_times)
        else:
            r0, tr0 = traj(t0)
            col_rot = jnp.broadcast_to(r0, (cfg.n_cols, 3, 3))
            col_trans = jnp.broadcast_to(tr0, (cfg.n_cols, 3))
        scan = simulate_scan(scene, model, col_rot, col_trans, key, scan_period=period_s)
        gt_rot, gt_trans = traj(t0)
        return scan, gt_rot, gt_trans

    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.n_scans)
    for i in range(cfg.n_scans):
        t0 = i * period_s
        scan, gt_rot, gt_trans = one_scan(jnp.asarray(t0, jnp.float32), keys[i])
        mask = np.asarray(scan.mask)
        yield SimFrame(
            stamp=t0,
            points=np.asarray(scan.xyz)[mask],
            ring=np.asarray(scan.ring)[mask],
            rel_time=np.asarray(scan.rel_time)[mask],
            gt_rot=np.asarray(gt_rot),
            gt_trans=np.asarray(gt_trans),
        )


def ground_map_points(cfg: SimConfig, scene: Optional[Scene] = None,
                      spacing: float = 0.5, margin: float = 8.0) -> np.ndarray:
    """Terrain samples covering the trajectory annulus — the external
    ground-mapping input the prior stack consumes (the "/voxel_map" topic,
    /root/reference/launch/module_prior.launch:9)."""
    scene = make_scene(cfg) if scene is None else scene
    ext = max(cfg.radius_x, cfg.radius_y) + margin
    xs = np.arange(-ext, ext, spacing, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs)
    xy = jnp.asarray(np.column_stack([gx.ravel(), gy.ravel()]))
    z = np.asarray(terrain_height(scene, xy))
    return np.column_stack([np.asarray(xy), z]).astype(np.float32)
