"""Layered configuration system for the SLAM engine.

Key-for-key re-design of the reference's ParamLoader
(/root/reference/include/rolo/utility.h:145-432): every tunable the reference
reads from the ROS parameter server exists here as a typed dataclass field
with the same default. Instead of a parameter server, configs load from YAML
(per-dataset files under configs/, same layering as reference config/*.yaml)
with dotted-key overrides.

Static *capacity* fields (max points, max keyframes, ...) are additions:
XLA needs fixed shapes, so every dynamic container in the reference becomes a
fixed-capacity padded array here. Capacities live in `StaticConfig` so jitted
functions can close over them as Python ints.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class SensorConfig:
    """Lidar geometry (utility.h:283-316)."""

    sensor: str = "velodyne"  # velodyne | ouster
    n_scan: int = 32
    horizon_scan: int = 1024
    downsample_rate: int = 1
    lidar_min_range: float = 2.0
    lidar_max_range: float = 1000.0
    lidar_noise_bound: float = 0.05
    # Deskew ON by default (round-4 decision): with ESKF-sourced increments
    # and the translational correction, the 300-scan A/B measures keyframe
    # ATE 0.022 m (on) vs 0.108 m (off) at identical keyframe/loop/prior
    # counts (the round-3 keyframe-collapse anomaly was an artifact of the
    # pre-round-4 solve feedback and is gone). The reference deskews too (imageProjection.cpp:266-396) — False was the
    # conservative round-2 default while the increment source was unstable.
    deskew_enabled: bool = True
    scan_period: float = 0.1  # 10 Hz design point (imageProjection.cpp:79)


@dataclass(frozen=True)
class FeatureConfig:
    """LOAM feature thresholds (utility.h:318-325, params.yaml)."""

    edge_threshold: float = 0.8
    surf_threshold: float = 0.1
    edge_feature_min_valid_num: int = 20
    surf_feature_min_valid_num: int = 100
    odometry_surf_leaf_size: float = 0.4
    max_corners_per_sector: int = 20  # featureExtraction.cpp:188
    sectors_per_ring: int = 6  # featureExtraction.cpp:170


@dataclass(frozen=True)
class RegistrationConfig:
    """rot-GICP solver parameters (lsq_registration_impl.hpp:11-19,
    rot_vgicp_impl.hpp:28-39, lidarOdometry.cpp:462)."""

    polar_resolution: Tuple[float, float, float] = (0.175, 0.175, 2.0)
    voxel_resolution: float = 1.0  # uniform-voxel mode
    voxel_type: str = "polar"  # polar | uniform
    neighbor_search: str = "direct1"  # direct1 | direct7 | direct27
    k_correspondences: int = 20
    regularization: str = "plane"  # plane | min_eig | normalized_min_eig | frobenius | none
    max_outer_iterations: int = 64
    lm_max_inner_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    ct_lambda: float = 0.3  # params.yaml continuousTrajectoryWeight
    # Correspondence rebinding rounds for the translation stage. The
    # reference binds once (the update_correspondences call inside
    # t3_linearize is commented out, rot_vgicp_impl.hpp:509-512), which
    # bounds per-scan translation recovery to ~the voxel-mean pull of the
    # initial binding and leans on forward prediction. A rebind is one more
    # batch of voxel lookups, so >1 round recovers large / cold-start
    # translations; 1 reproduces the reference exactly.
    ct_rebind_rounds: int = 4
    # Rotation/translation alternation rounds (knob with no reference
    # analog — the reference runs one rotation then one translation solve,
    # lidarOdometry.cpp:448-501). At zero/cold initial guess the
    # rotation-only stage absorbs part of the unmodeled translation
    # (~2 deg / ~0.1 m systematic undershoot along motion on the bench
    # workload); a second alternation removes it. 1 = reference flow.
    alt_rounds: int = 2
    # Fine translation stage: after the polar CT solve, re-solve the
    # translation against a UNIFORM voxel map at this resolution with
    # direct7 neighbors (no reference analog). The polar grid's 2 m radial bins are
    # built for rotation alignment; their voxel-mean quantization floors
    # translation accuracy at ~0.1-0.2 m. 0 disables (reference flow).
    ct_fine_resolution: float = 0.25
    ct_fine_neighbors: str = "direct7"
    # failureDetection gating (lidarOdometry.cpp:629-643): when True, a
    # step exceeding the velocity/rotation-rate bounds is REJECTED — the
    # pose holds at the previous estimate (the reset-banner path :567-569).
    # Default False = reference parity (the call sites are commented out,
    # :596-599); the flag is still computed and returned either way.
    enable_failure_gate: bool = False


@dataclass(frozen=True)
class MappingConfig:
    """Back-end scan-to-submap + keyframe params (utility.h:323-359)."""

    mapping_corner_leaf_size: float = 0.2
    mapping_surf_leaf_size: float = 0.4
    mapping_process_interval: float = 0.15
    z_tolerance: float = 1000.0
    rotation_tolerance: float = 1000.0
    surrounding_keyframe_adding_dist_threshold: float = 0.5
    surrounding_keyframe_adding_angle_threshold: float = 0.2
    surrounding_keyframe_density: float = 2.0
    surrounding_keyframe_search_radius: float = 50.0
    surrounding_keyframe_recency_sec: float = 10.0  # backMapping.cpp:600-608
    # Reference default is 30 (backMapping.cpp:692). The solve's <0.5 mm
    # convergence test rarely fires before the cap (kNN rebinds jitter the
    # frozen correspondences at the sub-mm level), so the cap IS the
    # iteration count; 16 kept the same sim-run ATE at half the backend
    # iterations in a 200-scan A/B.
    scan2map_max_iterations: int = 16
    # Iterations between correspondence re-searches in scan2map. The
    # reference rebinds every iteration (=1); the 5-NN dominates the
    # iteration cost while mapping refinement moves the pose sub-cm (no
    # reference analog). A 200-scan sim A/B gave keyframe ATE 0.0238 m
    # (rebind 1) / 0.0232 (5) / 0.0217 (10) — cadence-insensitive, so ship
    # the cheapest.
    scan2map_rebind_every: int = 10
    degeneracy_eigen_threshold: float = 100.0  # backMapping.cpp:1006-1035
    # Submap assembly keeps the nearest N eligible keyframes (the fixed-size
    # stand-in for the reference's 2 m pose-set voxel downsample,
    # backMapping.cpp:583-599). 32 nearest at the 0.5 m keyframe spacing
    # covers a ~16 m neighborhood — far beyond the <1 m correspondence
    # gate of the scan2map factors.
    surrounding_keyframe_max_nearby: int = 32
    # k-NN selector of the scan2map binds and the prior ICP correspondence
    # search: lax.approx_min_k (True) or lax.top_k (False). On the GPU and
    # the CPU XLA lowers approx_min_k to an exact selection, so both give
    # the same neighbours there; they differ only in speed (no reference
    # analog).
    approx_knn: bool = True
    # Candidate-set rebinding in scan2map: the full-submap k-NN runs once
    # per solve with this many neighbors; rebinds re-rank the candidates.
    # 0 = full search on the rebind schedule (no reference analog).
    # Default 0; kept for experimentation only.
    scan2map_candidates: int = 0
    # Host cadence (sim-time s) for dispatching the pose-graph re-solve
    # when loop/prior programs have run since the last solve (no
    # reference analog — the reference solves on every keyframe,
    # backMapping.cpp:1115). The solve is a pure async dispatch (bucket
    # from the host-side mapping-step count, no device fetch); corrections
    # apply up to this much later, matching the reference's own async
    # correctPoses-on-next-keyframe semantics.
    graph_solve_check_interval: float = 1.0


@dataclass(frozen=True)
class LoopConfig:
    """Loop closure (utility.h:340-359, Scancontext.h:80-99)."""

    enable: bool = True
    loop_close_type: str = "all"  # sc | rs | all
    sc_input_type: str = "scan_raw"  # scan_raw | scan_feat
    frequency_hz: float = 1.0
    surrounding_keyframe_size: int = 50
    history_search_radius: float = 30.0
    history_search_time_diff: float = 30.0
    history_search_num: int = 25
    history_fitness_score: float = 0.3
    # Scan-context descriptor geometry (Scancontext.h:80-99)
    sc_num_ring: int = 20
    sc_num_sector: int = 60
    sc_max_radius: float = 80.0
    sc_num_exclude_recent: int = 30
    sc_num_candidates: int = 10
    sc_search_ratio: float = 0.1
    sc_dist_threshold: float = 0.4
    sc_lidar_height: float = 2.0
    # ICP-verification cloud capacities (no reference analog — pcl::ICP
    # takes whatever loopFindNearKeyframes produces). The verification
    # ICP's per-iteration cost is src x tgt; 4096 x 16384 keeps
    # verification accuracy (fitness over thousands of downsampled points)
    # at 1/8 the work of 16384 x 32768, whose loop_closure_step blew the
    # 100 ms scan-latency budget whenever a loop fired; raise if loops
    # start failing the fitness gate on sparse maps.
    icp_src_capacity: int = 4096
    icp_tgt_capacity: int = 16384


@dataclass(frozen=True)
class PriorConfig:
    """Ground-contact prior stack (utility.h:360-424,
    prior_pose_params.yaml)."""

    enable: bool = True
    frequency_hz: float = 5.0  # priorFactorFrequency (prior_pose_params.yaml)
    ground_patch_size: float = 2.0
    near_prior_radius: float = 1.0
    fitness_score: float = 0.01
    time_validation: float = 1.0
    range_validation: float = 10.0
    rot_diff_tolerance_rad: float = 5.0 * math.pi / 180.0
    trans_diff_tolerance: float = 1.0
    factor_weight: float = 100.0
    synced_interval: float = 0.0
    # PoseSolver / vehicle model (utility.h:380-398)
    vehicle_size_xy: float = 2.0
    vehicle_com_z: float = 1.0
    k_spring: float = 20.0
    gravity: float = 1.0
    max_iters: int = 60
    lm_lambda: float = 1e-2
    # Reference defaults are 1e-12 / 1e-10 (prior_pose_params.yaml), sized
    # for the f64 Eigen solver; the f32 solver here bottoms out near 1e-8
    # cost deltas, so these are rescaled to keep the same "converged within
    # max_iters" semantics (PoseSolver::Solve, pose_solver.cpp:467-471).
    tol_cost: float = 1e-8
    # 1e-5 rejects ~half of otherwise-good solves in f32: LM steps on
    # meter-scale z bottom out at ~1e-5..1e-4 (measured fail_conv 28/61
    # prior ticks on a sim diagnostic); the
    # roll/pitch/wheel-distance FailureDetection gates still reject bad
    # solutions after convergence.
    tol_step: float = 1e-4
    ground_avg_radius: float = 0.3
    ground_min_neighbors: int = 5
    tolerance_z_min: float = -10.0
    tolerance_z_max: float = 10.0
    tolerance_roll: float = 1.0
    tolerance_pitch: float = 1.0
    tolerance_wheel_distance: float = 1.0
    wheel_xy: Tuple[Tuple[float, float], ...] = ()
    lidar_offset_trans: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # Live ground mapping (the in-repo analog of the reference's EXTERNAL
    # `point_seg ground_mapping` /voxel_map input,
    # launch/module_prior.launch:9): ground segmented from each scan
    # (LeGO-LOAM inter-ring slope test) accumulates into a rolling
    # world-frame map consistent with the drifting estimate. Used whenever
    # no external map was provided via SlamSystem.set_ground_map.
    ground_seg_slope_deg: float = 10.0
    ground_seg_rings: int = 0  # 0 = lower half of the rings


@dataclass(frozen=True)
class FilterConfig:
    """Pose ESKF options, key-for-key with PoseESEKF::Options
    (eskf.hpp:55-69)."""

    max_dt: float = 1.0
    q_linear_jerk_std: float = 0.5
    q_angular_jerk_std: float = 0.5
    r_position_std: float = 0.20
    r_rotation_std: float = 0.10
    init_position_std: float = 0.05
    init_rotation_std: float = 0.05
    init_velocity_std: float = 5.0
    init_angular_velocity_std: float = 2.0
    init_acceleration_std: float = 5.0
    init_angular_acceleration_std: float = 2.0
    maximum_iteration: int = 3
    convergence_limit: float = 1e-4
    # statePropagate(0.2, 8.0): 0.2 s steps until 8 m of travel
    # (lidarOdometry.cpp:259 predictTimerHandler)
    propagate_step_dt: float = 0.2
    propagate_horizon_m: float = 8.0
    propagate_max_steps: int = 64  # static rollout capacity (no reference analog)


@dataclass(frozen=True)
class StaticConfig:
    """Fixed array capacities for XLA static shapes (no reference
    analog — the reference uses std::vector everywhere)."""

    max_raw_points: int = 65536  # >= n_scan * horizon_scan for the main configs
    max_extracted_points: int = 32768
    max_corner_points: int = 4096
    max_surf_points: int = 12288
    # Front-end feature capacity: sized for the main 32-beam/1024-col
    # config (observed ~5.5k valid features/scan; concat_clouds compacts
    # valid-first and truncates overflow). Dense sensors (Ouster-64@2048)
    # raise this via the per-dataset tpu: config namespace. Covariance and
    # linearize cost grow with capacity, so headroom is not free.
    max_feature_points: int = 8192  # corner + surf stacked
    max_voxels: int = 8192
    max_keyframes: int = 2048
    # Submap cap: real submaps carry ~3k corner / ~27k surf points after
    # the 0.2/0.4 leaf downsample; 32768 halves every scan2map bind vs the
    # old 65536 with zero truncation in practice.
    max_submap_points: int = 32768
    max_loop_factors: int = 256
    max_prior_factors: int = 512
    knn_query_chunk: int = 512
    # live ground map ring buffer: slots x points/slot (one slot per
    # mapping step -> ~13 s of trail at the default cadences)
    live_ground_slots: int = 64
    live_ground_slot_points: int = 512
    # What the runtime does when a fixed-capacity store drops an event
    # (BackendState.dropped_counts): "warn" logs once per category and keeps
    # going; "error" raises CapacityExhausted. Never silent.
    on_capacity: str = "warn"  # warn | error


@dataclass(frozen=True)
class RoloConfig:
    """Top-level config bundle; mirrors the rolo/ + prior_factor/ +
    prior_pose_node/ namespaces of the reference parameter server."""

    sensor: SensorConfig = field(default_factory=SensorConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    static: StaticConfig = field(default_factory=StaticConfig)
    save_pcd: bool = False
    save_pcd_directory: str = "/results/"

    def replace(self, **kwargs) -> "RoloConfig":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# YAML loading with the reference's key names
# ---------------------------------------------------------------------------

# Map from the reference's flat param names (params.yaml / utility.h) to
# (section, field) in RoloConfig.
_REFERENCE_KEYMAP = {
    "sensor": ("sensor", "sensor"),
    "N_SCAN": ("sensor", "n_scan"),
    "Horizon_SCAN": ("sensor", "horizon_scan"),
    "downsampleRate": ("sensor", "downsample_rate"),
    "lidarMinRange": ("sensor", "lidar_min_range"),
    "lidarMaxRange": ("sensor", "lidar_max_range"),
    "lidarNoiseBound": ("sensor", "lidar_noise_bound"),
    "deskewEnabled": ("sensor", "deskew_enabled"),
    "edgeThreshold": ("features", "edge_threshold"),
    "surfThreshold": ("features", "surf_threshold"),
    "edgeFeatureMinValidNum": ("features", "edge_feature_min_valid_num"),
    "surfFeatureMinValidNum": ("features", "surf_feature_min_valid_num"),
    "odometrySurfLeafSize": ("features", "odometry_surf_leaf_size"),
    "mappingCornerLeafSize": ("mapping", "mapping_corner_leaf_size"),
    "mappingSurfLeafSize": ("mapping", "mapping_surf_leaf_size"),
    "z_tollerance": ("mapping", "z_tolerance"),
    "rotation_tollerance": ("mapping", "rotation_tolerance"),
    "mappingProcessInterval": ("mapping", "mapping_process_interval"),
    "continuousTrajectoryWeight": ("registration", "ct_lambda"),
    "surroundingkeyframeAddingDistThreshold": ("mapping", "surrounding_keyframe_adding_dist_threshold"),
    "surroundingkeyframeAddingAngleThreshold": ("mapping", "surrounding_keyframe_adding_angle_threshold"),
    "surroundingKeyframeDensity": ("mapping", "surrounding_keyframe_density"),
    "surroundingKeyframeSearchRadius": ("mapping", "surrounding_keyframe_search_radius"),
    "loopClosureEnableFlag": ("loop", "enable"),
    "loopCloseType": ("loop", "loop_close_type"),
    "scInputType": ("loop", "sc_input_type"),
    "loopClosureFrequency": ("loop", "frequency_hz"),
    "surroundingKeyframeSize": ("loop", "surrounding_keyframe_size"),
    "historyKeyframeSearchRadius": ("loop", "history_search_radius"),
    "historyKeyframeSearchTimeDiff": ("loop", "history_search_time_diff"),
    "historyKeyframeSearchNum": ("loop", "history_search_num"),
    "historyKeyframeFitnessScore": ("loop", "history_fitness_score"),
    "savePCD": (None, "save_pcd"),
    "savePCDDirectory": (None, "save_pcd_directory"),
}

_PRIOR_FACTOR_KEYMAP = {
    "priorFactorEnableFlag": "enable",
    "priorFactorFrequency": "frequency_hz",
    "groundPatchSize": "ground_patch_size",
    "nearPriorRadius": "near_prior_radius",
    "priorFitnessScore": "fitness_score",
    "priorTimeValidation": "time_validation",
    "priorRangeValidation": "range_validation",
    "priorTransDiffTolerance": "trans_diff_tolerance",
    "priorFactorWeight": "factor_weight",
    "priorSyncedInterval": "synced_interval",
}

_PRIOR_POSE_KEYMAP = {
    "vehicle_size_xy": "vehicle_size_xy",
    "vehicle_com_z": "vehicle_com_z",
    "k_spring": "k_spring",
    "g": "gravity",
    "max_iters": "max_iters",
    "lm_lambda": "lm_lambda",
    "tol_cost": "tol_cost",
    "tol_step": "tol_step",
    "ground_avg_radius": "ground_avg_radius",
    "ground_min_neighbors": "ground_min_neighbors",
    "tolerance_z_min": "tolerance_z_min",
    "tolerance_z_max": "tolerance_z_max",
    "tolerance_roll": "tolerance_roll",
    "tolerance_pitch": "tolerance_pitch",
    "tolerance_wheel_distance": "tolerance_wheel_distance",
}


def _apply_namespace(cfg: RoloConfig, ns: dict) -> RoloConfig:
    sections = {f.name: dict(vars(getattr(cfg, f.name))) if dataclasses.is_dataclass(getattr(cfg, f.name)) else None
                for f in dataclasses.fields(cfg)}
    top_level = {}

    def set_kv(section: Optional[str], fname: str, value):
        if section is None:
            top_level[fname] = value
        else:
            sections[section][fname] = value

    rolo_ns = ns.get("rolo", {}) or {}
    for key, value in rolo_ns.items():
        if key in _REFERENCE_KEYMAP:
            section, fname = _REFERENCE_KEYMAP[key]
            set_kv(section, fname, value)
    pf_ns = ns.get("prior_factor", {}) or {}
    for key, value in pf_ns.items():
        if key == "priorRotDiffTolerance":
            sections["prior"]["rot_diff_tolerance_rad"] = float(value) * math.pi / 180.0
        elif key in _PRIOR_FACTOR_KEYMAP:
            sections["prior"][_PRIOR_FACTOR_KEYMAP[key]] = value
    # Capacity/knob namespace `tpu:` (its historical name; no reference
    # analog): sections by python field name,
    # e.g. tpu: {static: {max_raw_points: 16384}, registration: {...}}.
    # Unknown sections/fields are loud errors — silent typos in capacity
    # configs would otherwise surface as OOMs or truncation much later.
    tpu_ns = ns.get("tpu", {}) or {}
    for sec_name, sec_vals in tpu_ns.items():
        if sec_name not in sections or sections[sec_name] is None:
            raise ValueError(f"unknown tpu config section: {sec_name!r}")
        if not isinstance(sec_vals, dict):
            raise ValueError(f"tpu.{sec_name} must be a mapping")
        for k, v in sec_vals.items():
            if k not in sections[sec_name]:
                raise ValueError(f"unknown tpu config key: {sec_name}.{k}")
            sections[sec_name][k] = v

    pp_ns = ns.get("prior_pose_node", {}) or {}
    for key, value in pp_ns.items():
        if key == "wheel_xy":
            flat = [float(v) for v in value]
            sections["prior"]["wheel_xy"] = tuple(
                (flat[i], flat[i + 1]) for i in range(0, len(flat) - 1, 2)
            )
        elif key == "lidarOffsetTrans":
            sections["prior"]["lidar_offset_trans"] = tuple(float(v) for v in value)
        elif key in _PRIOR_POSE_KEYMAP:
            sections["prior"][_PRIOR_POSE_KEYMAP[key]] = value

    new_sections = {}
    for f in dataclasses.fields(cfg):
        current = getattr(cfg, f.name)
        if dataclasses.is_dataclass(current):
            new_sections[f.name] = type(current)(**sections[f.name])
        else:
            new_sections[f.name] = top_level.get(f.name, current)
    return RoloConfig(**new_sections)


def load_config(yaml_path=None, overrides: Optional[dict] = None) -> RoloConfig:
    """Load a RoloConfig: defaults <- yaml file(s) (reference key names,
    applied in order — e.g. params.yaml then a per-dataset
    prior_pose_params.yaml, the reference's two-file layout) <- dotted
    overrides like {"registration.ct_lambda": 0.5}."""
    cfg = RoloConfig()
    if yaml_path is not None:
        import yaml

        paths = [yaml_path] if isinstance(yaml_path, (str, bytes)) else list(yaml_path)
        for p in paths:
            with open(p) as f:
                ns = yaml.safe_load(f) or {}
            cfg = _apply_namespace(cfg, ns)
    if overrides:
        for dotted, value in overrides.items():
            parts = dotted.split(".")
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: value})
            else:
                section = getattr(cfg, parts[0])
                section = dataclasses.replace(section, **{parts[1]: value})
                cfg = dataclasses.replace(cfg, **{parts[0]: section})
    return cfg
