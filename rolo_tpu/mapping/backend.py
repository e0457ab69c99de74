"""Back-end orchestrator: scan-to-submap optimization, keyframe/factor
management, loop closure, ground priors, and pose-graph correction.

JAX re-design of the backMapping node's main path
(/root/reference/src/backMapping.cpp:420-513 laserCloudInfoHandler) and its
background threads. The reference splits this across one mutex-guarded
process with three threads; here it is a pure
`backend_step(state, scan_inputs) -> (state, output)` plus explicit
`loop_closure_step` / `prior_step` functions the runtime calls at their
reference cadences (1 Hz / 5 Hz; SURVEY.md section 2.7). All state is one
pytree — the checkpoint/resume unit.

Where the reference runs iSAM2 incrementally (:1115-1126), this build
re-solves the full pose graph with batched GN+PCG (graph/solver.py) — but
only when new loop/prior factors are pending: with an odometry-chain-only
graph the solution equals the initial estimate, so the solve is skipped
(exactly the regime where isam->update() is a no-op correction-wise).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import RoloConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..graph.factors import BetweenFactors, PoseGraph, add_between, empty_graph
from ..graph.solver import solve_pose_graph
from ..loop import closure as loopmod
from ..loop import scancontext as sc
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..prior import association as priormod
from .keyframes import KeyframeDB, add_keyframe, extract_submap, init_db, should_add_keyframe
from .scan2map import constrain_transform, scan2map_optimize


class BackendState(NamedTuple):
    db: KeyframeDB
    graph: PoseGraph
    scdb: sc.ScanContextDB
    prior_queue: priormod.PriorQueue
    loop_matched: jnp.ndarray  # [K] bool, loopIndexContainer analog
    rpy: jnp.ndarray  # [3] transformTobeMapped[0:3]
    xyz: jnp.ndarray  # [3] transformTobeMapped[3:6]
    last_front_rot: jnp.ndarray  # [3,3] lastOdomTransformation
    last_front_trans: jnp.ndarray  # [3]
    has_front: jnp.ndarray  # [] bool (lastOdomTransAvailable)
    pending_solve: jnp.ndarray  # [] bool (aLoopIsClosed analog)
    # host-visible capacity-exhaustion counters: events DROPPED because a
    # fixed-capacity store was full, order (keyframes, loop factors, prior
    # factors, prior queue overwrites). Never silently zero — the runtime
    # escalates per StaticConfig.on_capacity.
    dropped_counts: jnp.ndarray  # [4] int32


class BackendOutput(NamedTuple):
    """publishOdometry payload (backMapping.cpp:1341-1396)."""

    rot: jnp.ndarray  # [3,3] mapping pose
    trans: jnp.ndarray  # [3]
    keyframe_added: jnp.ndarray  # [] bool
    degenerate: jnp.ndarray  # [] bool (covariance[0] flag :1385-1388)
    s2m_iterations: jnp.ndarray
    num_factors: jnp.ndarray
    # capacity saturation: True when a keyframe add was gated in but DROPPED
    # because the fixed-capacity DB is full. The reference's std::vector
    # grows unboundedly (backMapping.cpp:115-122); static shapes can't, so
    # exhaustion must be host-visible, not silent (the runtime escalates per
    # StaticConfig.on_capacity).
    keyframe_dropped: jnp.ndarray  # [] bool
    # pending_solve & keyframe_added. The round-4 runtime schedules the
    # bucketed graph solve from host-side dispatch knowledge instead of
    # fetching this (a device-value fetch fences the whole dispatch
    # queue); kept for tests and non-async drivers.
    solve_due: jnp.ndarray  # [] bool


def init_backend(cfg: RoloConfig, dtype=jnp.float32) -> BackendState:
    st = cfg.static
    return BackendState(
        db=init_db(st.max_keyframes, st.max_corner_points, st.max_surf_points, dtype),
        graph=empty_graph(st.max_keyframes, st.max_loop_factors, st.max_prior_factors, dtype),
        scdb=sc.init_db(st.max_keyframes, cfg.loop.sc_num_ring, cfg.loop.sc_num_sector, dtype),
        prior_queue=priormod.init_queue(st.max_prior_factors, 2048, dtype),
        loop_matched=jnp.zeros((st.max_keyframes,), bool),
        rpy=jnp.zeros(3, dtype),
        xyz=jnp.zeros(3, dtype),
        last_front_rot=jnp.eye(3, dtype=dtype),
        last_front_trans=jnp.zeros(3, dtype),
        has_front=jnp.asarray(False),
        pending_solve=jnp.asarray(False),
        dropped_counts=jnp.zeros(4, jnp.int32),
    )


def _update_initial_guess(state: BackendState, front_rot, front_trans, odom_available):
    """updateInitialGuess (backMapping.cpp:516-555): compose the front-end
    increment since the last scan onto the current mapped pose."""
    cur = SE3(so3.rpy_to_matrix(state.rpy[0], state.rpy[1], state.rpy[2]), state.xyz)
    front = SE3(front_rot, front_trans)
    incre = SE3(state.last_front_rot, state.last_front_trans).inverse().compose(front)
    guessed = cur.compose(incre)

    use = odom_available & state.has_front & (state.db.count > 0)
    rot = jnp.where(use, guessed.rot, cur.rot)
    trans = jnp.where(use, guessed.trans, cur.trans)
    roll, pitch, yaw = so3.matrix_to_rpy(rot)
    return jnp.stack([roll, pitch, yaw]), trans


@partial(jax.jit, static_argnames=("cfg",))
def backend_step(
    state: BackendState,
    corner: PaddedCloud,
    surf: PaddedCloud,
    sc_cloud: PaddedCloud,
    front_rot: jnp.ndarray,
    front_trans: jnp.ndarray,
    odom_available: jnp.ndarray,
    scan_time: jnp.ndarray,
    cfg: RoloConfig,
) -> Tuple[BackendState, BackendOutput]:
    """One mapping step (laserCloudInfoHandler, backMapping.cpp:420-457):
    initial guess -> submap extraction -> downsample -> scan-to-submap GN
    -> keyframe gating -> factors -> (conditional) graph solve."""
    st = cfg.static
    m = cfg.mapping
    dtype = state.xyz.dtype

    rpy, xyz = _update_initial_guess(state, front_rot, front_trans, odom_available)

    # downsampleCurrentScan (:666-678)
    corner_ds = voxel_downsample(corner, m.mapping_corner_leaf_size, st.max_corner_points)
    surf_ds = voxel_downsample(surf, m.mapping_surf_leaf_size, st.max_surf_points)

    # extractSurroundingKeyFrames + scan2MapOptimization, gated on having
    # keyframes (:558-560, :687)
    def optimize(rpy, xyz):
        sub_c, sub_s = extract_submap(
            state.db, xyz, scan_time,
            m.surrounding_keyframe_search_radius, m.surrounding_keyframe_recency_sec,
            max_nearby=m.surrounding_keyframe_max_nearby,
            corner_out_cap=st.max_submap_points,
            surf_out_cap=st.max_submap_points,
            corner_leaf=m.mapping_corner_leaf_size, surf_leaf=m.mapping_surf_leaf_size,
        )
        res = scan2map_optimize(
            rpy, xyz, corner_ds.xyz, corner_ds.mask, surf_ds.xyz, surf_ds.mask,
            sub_c, sub_s, max_iterations=m.scan2map_max_iterations,
            degeneracy_threshold=m.degeneracy_eigen_threshold,
            chunk=st.knn_query_chunk,
            rebind_every=m.scan2map_rebind_every,
            approx_knn=m.approx_knn,
            n_candidates=m.scan2map_candidates,
        )
        return res.rpy, res.trans, res.degenerate, res.iterations, res.num_factors

    def skip(rpy, xyz):
        return rpy, xyz, jnp.array(False), jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32)

    rpy, xyz, degen, iters, nfac = jax.lax.cond(state.db.count > 0, optimize, skip, rpy, xyz)
    rpy, xyz = constrain_transform(rpy, xyz, m.rotation_tolerance, m.z_tolerance)
    pose = SE3(so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2]), xyz)

    # --- saveKeyFramesAndFactor (:1094-1221) ---------------------------
    add = should_add_keyframe(
        state.db, pose,
        m.surrounding_keyframe_adding_dist_threshold,
        m.surrounding_keyframe_adding_angle_threshold,
    )
    new_idx = state.db.count  # index this keyframe will take

    db = jax.tree_util.tree_map(
        lambda a, b: jnp.where(add, b, a),
        state.db,
        add_keyframe(state.db, pose, scan_time, corner_ds, surf_ds),
    )

    # odometry factor / first prior (addOdomFactor :1224-1243)
    last = SE3(state.db.rot[jnp.maximum(state.db.count - 1, 0)],
               state.db.trans[jnp.maximum(state.db.count - 1, 0)])
    rel = last.inverse().compose(pose)
    graph = state.graph
    is_first = state.db.count == 0
    graph = graph._replace(
        first_rot=jnp.where(add & is_first, pose.rot, graph.first_rot),
        first_trans=jnp.where(add & is_first, pose.trans, graph.first_trans),
        odom_rel_rot=jnp.where(
            add & ~is_first,
            graph.odom_rel_rot.at[jnp.minimum(new_idx, st.max_keyframes - 1)].set(rel.rot),
            graph.odom_rel_rot,
        ),
        odom_rel_trans=jnp.where(
            add & ~is_first,
            graph.odom_rel_trans.at[jnp.minimum(new_idx, st.max_keyframes - 1)].set(rel.trans),
            graph.odom_rel_trans,
        ),
    )

    # scan-context descriptor for the new keyframe (:1183-1216)
    desc = sc.make_descriptor(
        sc_cloud.xyz, sc_cloud.mask,
        cfg.loop.sc_num_ring, cfg.loop.sc_num_sector,
        cfg.loop.sc_max_radius, cfg.loop.sc_lidar_height,
    )
    scdb = jax.tree_util.tree_map(
        lambda a, b: jnp.where(add, b, a), state.scdb, sc.add_descriptor(state.scdb, desc)
    )

    # Pose-graph solve moved OUT of the jitted step: the runtime dispatches
    # solve_graph_host (bucketed dense GN) at its own cadence whenever
    # loop/prior programs have run — the reference's isam->update +
    # correctPoses sequence (:1115-1137, :1287) runs on the keyframe path.
    # Keeping the solve out of the step lets it compile at the smallest
    # capacity bucket covering the live pose count instead of the full 2048.
    pending = state.pending_solve
    out_rot = pose.rot
    out_trans = pose.trans
    roll, pitch, yaw = so3.matrix_to_rpy(out_rot)

    dropped = add & (state.db.count >= st.max_keyframes)
    new_state = BackendState(
        db=db,
        graph=graph,
        scdb=scdb,
        prior_queue=state.prior_queue,
        loop_matched=state.loop_matched,
        rpy=jnp.stack([roll, pitch, yaw]),
        xyz=out_trans,
        last_front_rot=front_rot,
        last_front_trans=front_trans,
        has_front=state.has_front | odom_available,
        pending_solve=pending,
        dropped_counts=state.dropped_counts.at[0].add(dropped.astype(jnp.int32)),
    )
    return new_state, BackendOutput(
        rot=out_rot, trans=out_trans, keyframe_added=add & ~dropped,
        degenerate=degen, s2m_iterations=iters, num_factors=nfac,
        keyframe_dropped=dropped,
        solve_due=pending & add,
    )


# Capacity buckets for the host-driven graph solve: the dense GN re-solve
# compiles per bucket, and a run with k keyframes only ever pays for the
# smallest bucket >= k (the full 2048 bucket only compiles if a run
# actually grows that far).
_SOLVE_BUCKETS = (64, 128, 256, 512, 1024, 2048)


@partial(jax.jit, static_argnames=())
def _apply_solution(state: BackendState, sol_rot, sol_trans) -> BackendState:
    """Write a bucket's solved poses back into the full-capacity DB and
    apply the latest keyframe's CORRECTION to transformTobeMapped
    (correctPoses + backMapping.cpp:1165-1171).

    The reference solves on the keyframe path, where "latest estimate" and
    "current scan pose" coincide; this build's solve is deferred up to
    graph_solve_check_interval behind the scan stream, so overwriting
    transformTobeMapped with the latest KEYFRAME pose would roll back the
    mapping steps since (measured: a no-op odom-only solve at 1 Hz
    inflated keyframe count 304 -> 450 on a 900-scan run by repeatedly
    resetting the pose ~1 s backwards). Applying the left delta
    `solved ∘ oldᵀ` keeps no-op solves exactly no-ops and moves the
    current pose by the same world correction the keyframe received."""
    b = sol_rot.shape[0]
    db = state.db
    latest = jnp.maximum(db.count - 1, 0)
    old_latest = SE3(db.rot[latest], db.trans[latest])
    valid = (jnp.arange(b) < db.count)
    rot = db.rot.at[:b].set(jnp.where(valid[:, None, None], sol_rot, db.rot[:b]))
    trans = db.trans.at[:b].set(jnp.where(valid[:, None], sol_trans, db.trans[:b]))
    db = db._replace(rot=rot, trans=trans)
    new_latest = SE3(db.rot[latest], db.trans[latest])
    delta = new_latest.compose(old_latest.inverse())
    cur = SE3(so3.rpy_to_matrix(state.rpy[0], state.rpy[1], state.rpy[2]), state.xyz)
    cur = delta.compose(cur)
    roll, pitch, yaw = so3.matrix_to_rpy(cur.rot)
    return state._replace(
        db=db,
        rpy=jnp.stack([roll, pitch, yaw]),
        xyz=cur.trans,
        pending_solve=jnp.asarray(False),
    )


def solve_graph_host(
    state: BackendState, cfg: RoloConfig = None, count_hint: int = None
) -> BackendState:
    """Host-driven pose-graph solve + correctPoses (backMapping.cpp:
    1115-1137, 1287-1320): slice the graph/DB to the smallest capacity
    bucket covering the live keyframe count, run the dense GN re-solve,
    and scatter the corrected poses back.

    `count_hint`: host-known UPPER BOUND on the keyframe count (e.g. the
    number of mapping steps driven). When given, the bucket is chosen from
    it and NO device value is fetched — a fetch fences the whole dispatch
    queue (with the async driver running ~10 scans deep), so the hint
    turns the solve into a pure async dispatch.
    A too-large hint only costs a bigger bucket, never correctness: the
    solver masks by the device-side db.count."""
    count = int(state.db.count) if count_hint is None else int(count_hint)
    if count < 1:
        return state._replace(pending_solve=jnp.asarray(False))
    cap = state.db.capacity
    bucket = next((b for b in _SOLVE_BUCKETS if b >= count and b <= cap), cap)
    g = state.graph
    g_b = g._replace(
        odom_rel_rot=g.odom_rel_rot[:bucket],
        odom_rel_trans=g.odom_rel_trans[:bucket],
    )
    # method="bcr": block cyclic reduction on the odometry chain +
    # Woodbury for loop/prior factors (graph/solver.py _bcr_step):
    # O(K log K) batched small ops instead of the dense [6K, 6K] Cholesky's
    # ~cubic growth, bounding loop-correction staleness on long
    # trajectories. Its time on the GPU is not measured yet.
    sol = solve_pose_graph(
        g_b, state.db.rot[:bucket], state.db.trans[:bucket], state.db.count,
        method="bcr",
    )
    return _apply_solution(state, sol.rot, sol.trans)


@partial(jax.jit, static_argnames=("cfg",))
def loop_closure_step(state: BackendState, cfg: RoloConfig) -> Tuple[BackendState, jnp.ndarray]:
    """One loop-closure pass (loopClosureThread body,
    backMapping.cpp:1904-1927): scan-context detection and/or radius-search
    detection per `loop_close_type`, ICP verification, factor insertion.
    Returns (state, closed_any)."""
    lc = cfg.loop
    st = cfg.static
    dtype = state.xyz.dtype
    cur = jnp.maximum(state.db.count - 1, 0)

    do_sc = lc.loop_close_type in ("sc", "all")
    do_rs = lc.loop_close_type in ("rs", "all")

    graph = state.graph
    matched = state.loop_matched
    closed = jnp.asarray(False)
    loop_drops = jnp.asarray(0, jnp.int32)

    def try_close(prev_idx, init_yaw, robust, found):
        cur_sub = loopmod.assemble_loop_submap(
            state.db, cur, 0, min(lc.icp_src_capacity, st.max_submap_points // 2),
            cfg.mapping.mapping_surf_leaf_size,
        )
        prev_sub = loopmod.assemble_loop_submap(
            state.db, prev_idx, lc.history_search_num,
            min(lc.icp_tgt_capacity, st.max_submap_points),
            cfg.mapping.mapping_surf_leaf_size,
        )
        factor = loopmod.verify_loop(
            state.db, cur, prev_idx, cur_sub, prev_sub, init_yaw,
            max_corr_dist=(150.0 if robust else lc.history_search_radius * 2.0),
            fitness_threshold=lc.history_fitness_score, robust=robust,
            # exact k-NN here (ADVICE round-2): with the 150 m robust-mode
            # gate, a missed neighbour can admit an arbitrarily far
            # correspondence into the unweighted SVD alignment, and the
            # accept/reject fitness must be exactly scored. On the GPU
            # `approx_min_k` lowers to an exact top-k, so both settings
            # select the same neighbours there; the flag pins the intent
            approx_knn=False,
        )
        return factor._replace(accepted=factor.accepted & found)

    def no_factor():
        return loopmod.LoopFactor(
            i=jnp.asarray(0, jnp.int32), j=jnp.asarray(0, jnp.int32),
            rel_rot=jnp.eye(3, dtype=dtype), rel_trans=jnp.zeros(3, dtype),
            noise_var=jnp.ones(6, dtype), robust_c=jnp.asarray(0.0, dtype),
            accepted=jnp.asarray(False),
        )

    if lc.enable and do_sc:
        det = sc.detect_loop(state.scdb, lc)
        sc_found = det.found & (det.index != cur) & (state.db.count > 0)
        factor = jax.lax.cond(
            sc_found,
            lambda: try_close(det.index, det.yaw_rad, True, sc_found),
            no_factor,
        )
        loop_drops += (factor.accepted & (graph.loops.count >= graph.loops.capacity)).astype(jnp.int32)
        graph = graph._replace(
            loops=add_between(
                graph.loops, factor.i, factor.j, factor.rel_rot, factor.rel_trans,
                factor.noise_var, factor.robust_c, enable=factor.accepted,
            )
        )
        matched = jnp.where(factor.accepted, matched.at[factor.i].set(True), matched)
        closed = closed | factor.accepted

    if lc.enable and do_rs:
        prev_idx, rs_found = loopmod.detect_loop_distance(
            state.db, matched, lc.history_search_radius, lc.history_search_time_diff
        )
        factor = jax.lax.cond(
            rs_found,
            lambda: try_close(prev_idx, jnp.asarray(0.0, dtype), False, rs_found),
            no_factor,
        )
        loop_drops += (factor.accepted & (graph.loops.count >= graph.loops.capacity)).astype(jnp.int32)
        graph = graph._replace(
            loops=add_between(
                graph.loops, factor.i, factor.j, factor.rel_rot, factor.rel_trans,
                factor.noise_var, factor.robust_c, enable=factor.accepted,
            )
        )
        matched = jnp.where(factor.accepted, matched.at[factor.i].set(True), matched)
        closed = closed | factor.accepted

    return (
        state._replace(
            graph=graph, loop_matched=matched,
            pending_solve=state.pending_solve | closed,
            dropped_counts=state.dropped_counts.at[1].add(loop_drops),
        ),
        closed,
    )


@partial(jax.jit, static_argnames=("cfg",))
def external_loop_step(
    state: BackendState,
    time_cur: jnp.ndarray,
    time_prev: jnp.ndarray,
    cfg: RoloConfig,
) -> Tuple[BackendState, jnp.ndarray]:
    """Accept one externally detected loop pair given as two timestamps
    (detectLoopClosureExternal, backMapping.cpp:2517-2570): map the times to
    keyframe indices (earliest keyframe at/after time_cur; latest keyframe
    at/before time_prev), reject pairs closer than
    `history_search_time_diff`, then ICP-verify and insert the factor with
    the RS (plain diagonal) noise convention. Returns (state, closed)."""
    lc = cfg.loop
    st = cfg.static
    db = state.db
    dtype = state.xyz.dtype
    idx = jnp.arange(db.capacity)
    valid = idx < db.count

    # reference walks times assuming monotone keyframe stamps
    ge = valid & (db.time >= time_cur)
    key_cur = jnp.where(jnp.any(ge), jnp.argmax(ge), jnp.maximum(db.count - 1, 0))
    le = valid & (db.time <= time_prev)
    key_prev = jnp.max(jnp.where(le, idx, 0))

    found = (
        (db.count >= 2)
        & (jnp.abs(time_cur - time_prev) >= lc.history_search_time_diff)
        & (key_cur != key_prev)
        & ~state.loop_matched[key_cur]
    )
    key_cur = key_cur.astype(jnp.int32)
    key_prev = key_prev.astype(jnp.int32)

    def try_close():
        cur_sub = loopmod.assemble_loop_submap(
            db, key_cur, 0, st.max_submap_points // 2, cfg.mapping.mapping_surf_leaf_size
        )
        prev_sub = loopmod.assemble_loop_submap(
            db, key_prev, lc.history_search_num,
            st.max_submap_points, cfg.mapping.mapping_surf_leaf_size,
        )
        factor = loopmod.verify_loop(
            db, key_cur, key_prev, cur_sub, prev_sub, jnp.asarray(0.0, dtype),
            max_corr_dist=lc.history_search_radius * 2.0,
            fitness_threshold=lc.history_fitness_score, robust=False,
            approx_knn=False,  # exact: fitness gates must not be approx-scored
        )
        return factor._replace(accepted=factor.accepted & found)

    def no_factor():
        return loopmod.LoopFactor(
            i=jnp.asarray(0, jnp.int32), j=jnp.asarray(0, jnp.int32),
            rel_rot=jnp.eye(3, dtype=dtype), rel_trans=jnp.zeros(3, dtype),
            noise_var=jnp.ones(6, dtype), robust_c=jnp.asarray(0.0, dtype),
            accepted=jnp.asarray(False),
        )

    factor = jax.lax.cond(found, try_close, no_factor)
    graph = state.graph
    drop = (factor.accepted & (graph.loops.count >= graph.loops.capacity)).astype(jnp.int32)
    graph = graph._replace(
        loops=add_between(
            graph.loops, factor.i, factor.j, factor.rel_rot, factor.rel_trans,
            factor.noise_var, factor.robust_c, enable=factor.accepted,
        )
    )
    matched = jnp.where(factor.accepted, state.loop_matched.at[factor.i].set(True), state.loop_matched)
    return (
        state._replace(
            graph=graph, loop_matched=matched,
            pending_solve=state.pending_solve | factor.accepted,
            dropped_counts=state.dropped_counts.at[1].add(drop),
        ),
        factor.accepted,
    )


@partial(jax.jit, static_argnames=("cfg",))
def prior_step(
    state: BackendState,
    ground_now: PaddedCloud,
    cfg: RoloConfig,
) -> Tuple[BackendState, jnp.ndarray]:
    """One prior-association pass (priorThread -> performPriorAssociation,
    backMapping.cpp:1929-1941, 1943-2158). The reference iterates stored
    priors and `break`s on the first match (:2147); here the xy-distance
    gate (:1981-1982, the first and cheapest gate) is evaluated for the
    whole queue vectorized, and the ICP + remaining gates run on the single
    nearest eligible entry under `lax.cond` — at most ONE ICP compiles into
    the step instead of one per queue slot. Returns (state, matched_any)."""
    q = state.prior_queue
    cur = jnp.maximum(state.db.count - 1, 0)
    cur_rot = state.db.rot[cur]
    cur_trans = state.db.trans[cur]
    dtype = cur_trans.dtype

    # --- vectorized prefilter: global prior xy for every queue entry ------
    idx_all = jnp.arange(q.capacity)
    linked_all = jnp.minimum(q.linked_key, state.db.capacity - 1)
    linked_rot = state.db.rot[linked_all]  # [P, 3, 3]
    linked_trans = state.db.trans[linked_all]  # [P, 3]
    prior_xy = (
        jnp.einsum("pij,pj->pi", linked_rot, q.rel_trans) + linked_trans
    )[:, :2]
    d2 = jnp.sum((prior_xy - cur_trans[:2]) ** 2, axis=-1)
    eligible = (
        q.valid
        & (idx_all < q.count)
        & (q.linked_key != cur)
        & (d2 < cfg.prior.near_prior_radius**2)
        & (state.db.count > 0)
    )
    score = jnp.where(eligible, d2, jnp.inf)
    pick = jnp.argmin(score).astype(jnp.int32)
    any_eligible = jnp.isfinite(score[pick])

    def run_icp():
        linked = linked_all[pick]
        return priormod.associate_prior(
            q.rel_rot[pick], q.rel_trans[pick], q.linked_key[pick],
            PaddedCloud(q.patch_xyz[pick], q.patch_mask[pick]),
            jnp.asarray(True),
            state.db.rot[linked], state.db.trans[linked],
            cur, cur_rot, cur_trans, ground_now, cfg.prior,
            approx_knn=cfg.mapping.approx_knn,
        )

    def no_match():
        return priormod.PriorFactor(
            i=jnp.asarray(0, jnp.int32), j=jnp.asarray(0, jnp.int32),
            rel_rot=jnp.eye(3, dtype=dtype), rel_trans=jnp.zeros(3, dtype),
            noise_var=jnp.ones(6, dtype), accepted=jnp.asarray(False),
        )

    factor = jax.lax.cond(any_eligible, run_icp, no_match)
    prior_drop = (
        factor.accepted & (state.graph.priors.count >= state.graph.priors.capacity)
    ).astype(jnp.int32)
    graph = state.graph._replace(
        priors=add_between(
            state.graph.priors, factor.i, factor.j, factor.rel_rot,
            factor.rel_trans, factor.noise_var, enable=factor.accepted,
        )
    )
    return (
        state._replace(
            graph=graph, pending_solve=state.pending_solve | factor.accepted,
            dropped_counts=state.dropped_counts.at[2].add(prior_drop),
        ),
        factor.accepted,
    )


@partial(jax.jit, static_argnames=("cfg",))
def record_prior_observation(
    state: BackendState,
    obs: priormod.PriorObservation,
    obs_time: jnp.ndarray = None,
    cfg: RoloConfig = None,
) -> BackendState:
    """priorInfoHandler (backMapping.cpp:459-513): link the observation to
    the latest keyframe and store it relative to that keyframe's pose.

    Acceptance gates (when `obs_time` is given, matching the reference):
      - at least 10 keyframes exist (`latestKeyID <= 9` reject, :475),
      - the observation is within 10 ms of the latest keyframe stamp (:475),
      - at least `priorSyncedInterval` elapsed since the last accepted
        prior (:479-488)."""
    cur = jnp.maximum(state.db.count - 1, 0)
    enable = state.db.count > 0
    if obs_time is not None:
        obs_time = jnp.asarray(obs_time, state.db.time.dtype)
        synced = cfg.prior.synced_interval if cfg is not None else 0.0
        enable = (
            enable
            & (state.db.count > 10)
            & (jnp.abs(obs_time - state.db.time[cur]) < 1e-2)
            & (obs_time - state.prior_queue.last_time >= synced)
        )
    q = priormod.push_prior(
        state.prior_queue, obs, cur, state.db.rot[cur], state.db.trans[cur],
        enable=enable, obs_time=obs_time,
    )
    wrapped = (enable & obs.success & (state.prior_queue.count >= state.prior_queue.capacity)).astype(jnp.int32)
    return state._replace(
        prior_queue=q, dropped_counts=state.dropped_counts.at[3].add(wrapped)
    )
