"""Offline visualization exports — the headless stand-in for the
reference's RViz observability (config/rviz/rolo.rviz, the global-map /
path / loop-marker / factor-graph publishers, backMapping.cpp:1341-1454,
1667-1900, 2626-2677).

Everything renders to files (PNG via matplotlib when available, PLY always)
so runs on headless accelerator hosts produce inspectable artifacts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def write_ply(path: str, xyz: np.ndarray, color: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud (viewable in CloudCompare/MeshLab)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    has_c = color is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_c:
            c = np.asarray(color).reshape(-1, 3).astype(np.uint8)
            for p, rgb in zip(xyz, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {rgb[0]} {rgb[1]} {rgb[2]}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def write_ply_graph(
    path: str,
    nodes: np.ndarray,
    edges: Sequence[Tuple[int, int]],
    edge_colors: Optional[Sequence[Tuple[int, int, int]]] = None,
) -> None:
    """ASCII PLY with vertex + edge elements — the pose graph as viewable
    wireframe (MeshLab/CloudCompare render `element edge` as segments).
    The PLY counterpart of publishGlobalGraph's edge MarkerArray
    (backMapping.cpp:1667-1900)."""
    nodes = np.asarray(nodes, np.float32).reshape(-1, 3)
    edges = [(int(i), int(j)) for i, j in edges]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {nodes.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        if edge_colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in nodes:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for k, (i, j) in enumerate(edges):
            if edge_colors is not None:
                r, g, b = edge_colors[k]
                f.write(f"{i} {j} {r} {g} {b}\n")
            else:
                f.write(f"{i} {j}\n")


def render_factor_graph(slam, path: str) -> bool:
    """Graph RENDERING (publishGlobalGraph, backMapping.cpp:1667-1900):
    keyframe nodes with heading axes, the odometry chain, loop edges (red)
    and prior factors (green) as a top-down PNG. Returns False when
    matplotlib is absent or the graph is empty."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    st = slam.backend_state
    k = int(st.db.count)
    if k == 0:
        return False
    pos = np.asarray(st.db.trans[:k])
    rot = np.asarray(st.db.rot[:k])

    fig, ax = plt.subplots(figsize=(9, 9))
    # odometry chain
    ax.plot(pos[:, 0], pos[:, 1], "-", color="0.6", linewidth=0.8, zorder=1,
            label="odometry chain")
    # nodes + heading axes (the per-node axis markers)
    ax.scatter(pos[:, 0], pos[:, 1], s=8, c="tab:blue", zorder=3, label="keyframes")
    step = max(1, k // 60)  # at most ~60 axis glyphs
    hx = rot[::step, :, 0]
    ax.quiver(pos[::step, 0], pos[::step, 1], hx[:, 0], hx[:, 1],
              angles="xy", scale_units="xy", scale=0.8, width=0.003,
              color="tab:blue", alpha=0.6, zorder=2)

    def draw_edges(f, color, label):
        n = int(f.count)
        first = True
        for e in range(n):
            i, j = int(f.i[e]), int(f.j[e])
            if i >= k or j >= k:
                continue
            ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]], "--",
                    color=color, linewidth=1.2, alpha=0.85, zorder=4,
                    label=label if first else None)
            first = False

    draw_edges(st.graph.loops, "tab:red", "loop edges")
    draw_edges(st.graph.priors, "tab:green", "prior factors")
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="best")
    ax.set_title(f"pose graph: {k} nodes, {int(st.graph.loops.count)} loops, "
                 f"{int(st.graph.priors.count)} priors")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_trajectory(
    path: str,
    trajectories: Sequence[Tuple[str, np.ndarray]],
    loops: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    title: str = "trajectory",
) -> bool:
    """Top-down XY plot of one or more trajectories with optional loop
    constraint segments (the visualizeLoopClosure marker set,
    backMapping.cpp:2626-2677). Returns False when matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    fig, ax = plt.subplots(figsize=(8, 8))
    for name, pos in trajectories:
        pos = np.asarray(pos).reshape(-1, 3)
        ax.plot(pos[:, 0], pos[:, 1], label=name, linewidth=1.2)
        if len(pos):
            ax.scatter([pos[0, 0]], [pos[0, 1]], marker="^", s=40)
    if loops:
        for a, b in loops:
            ax.plot([a[0], b[0]], [a[1], b[1]], "r--", linewidth=0.8, alpha=0.7)
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def export_factor_graph(slam, path: str) -> dict:
    """Structured factor-graph dump — the headless analog of
    publishGlobalGraph's node/axis/edge/factor MarkerArray
    (backMapping.cpp:1667-1900). JSON with keyframe nodes (pose + stamp),
    the odometry chain, loop edges (with noise + robust kernel), and prior
    factors; written to `path`, returned for in-process inspection."""
    import json

    from ..geometry import so3

    st = slam.backend_state
    k = int(st.db.count)
    nodes = []
    for i in range(k):
        import jax.numpy as jnp

        q = np.asarray(so3.matrix_to_quat(jnp.asarray(np.asarray(st.db.rot[i]))))
        nodes.append({
            "id": i,
            "time": float(st.db.time[i]),
            "xyz": np.asarray(st.db.trans[i]).round(4).tolist(),
            "quat_wxyz": q.round(5).tolist(),
        })

    def edges_of(f, with_noise=True):
        out = []
        for n in range(int(f.count)):
            e = {"i": int(f.i[n]), "j": int(f.j[n])}
            if with_noise:
                e["noise_var"] = np.asarray(f.noise_var[n]).round(6).tolist()
                e["robust_c"] = float(f.robust_c[n])
            out.append(e)
        return out

    graph = {
        "nodes": nodes,
        "odom_edges": [{"i": i - 1, "j": i} for i in range(1, k)],
        "loop_edges": edges_of(st.graph.loops),
        "prior_factors": edges_of(st.graph.priors),
        "drop_counts": dict(slam.drop_counts),
    }
    with open(path, "w") as f:
        json.dump(graph, f, indent=2)
    return graph


def export_prior_observability(slam, out_dir: str) -> int:
    """Prior-stack observability (the bounding-box + stacked-patch markers,
    backMapping.cpp:2253-2304): every stored prior patch as one PLY (green)
    with its xy bounding boxes in prior_boxes.json. Returns #priors."""
    import json

    q = slam.backend_state.prior_queue
    n = int(min(int(q.count), q.capacity))
    pts_all, boxes = [], []
    for i in range(n):
        mask = np.asarray(q.patch_mask[i])
        pts = np.asarray(q.patch_xyz[i])[mask]
        if not len(pts):
            continue
        pts_all.append(pts)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        boxes.append({
            "prior": i,
            "linked_key": int(q.linked_key[i]),
            "min": lo.round(3).tolist(),
            "max": hi.round(3).tolist(),
        })
    if pts_all:
        allp = np.concatenate(pts_all)
        color = np.tile(np.array([[60, 200, 60]], np.uint8), (len(allp), 1))
        write_ply(os.path.join(out_dir, "prior_patches.ply"), allp, color)
    with open(os.path.join(out_dir, "prior_boxes.json"), "w") as f:
        json.dump(boxes, f, indent=2)
    return n


def vehicle_outline(vehicle, rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Vehicle footprint polyline at a world pose — the headless analog of
    the mesh/model markers (prior_pose_node.cpp:238-286). The canonical
    box is rigidly aligned to the wheel contact points with weighted Kabsch
    (ComputeRigidAlignment, :29-64), then closed into a loop."""
    import jax.numpy as jnp

    from ..geometry.se3 import SE3, rigid_align

    wheels_b = np.asarray(vehicle.wheel_points_body)  # [W, 3]
    # canonical unit box corners in wheel order (closed loop)
    canon = np.asarray(
        [[-0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.5, -0.5, 0.0], [-0.5, -0.5, 0.0]],
        np.float32,
    )[: wheels_b.shape[0]]
    align = rigid_align(jnp.asarray(canon), jnp.asarray(wheels_b, np.float32))
    body = np.asarray(align.apply(jnp.asarray(canon)))
    world = body @ np.asarray(rot).T + np.asarray(trans)
    return np.concatenate([world, world[:1]], axis=0)


def export_run(slam, out_dir: str) -> None:
    """One-call artifact dump for a SlamSystem: trajectory plot, loop
    segments, and the global map as PLY (height-colored)."""
    os.makedirs(out_dir, exist_ok=True)
    st = slam.backend_state
    k = int(st.db.count)
    trajs = []
    if slam.front_positions:
        trajs.append(("front-end", slam.front_positions_np()))
    if k:
        trajs.append(("keyframes", np.asarray(st.db.trans[:k])))

    loops = []
    nl = int(st.graph.loops.count)
    for i in range(nl):
        a = np.asarray(st.db.trans[int(st.graph.loops.i[i])])
        b = np.asarray(st.db.trans[int(st.graph.loops.j[i])])
        loops.append((a, b))
    plot_trajectory(os.path.join(out_dir, "trajectory.png"), trajs, loops)

    clouds = []
    for i in range(k):
        rot = np.asarray(st.db.rot[i])
        trans = np.asarray(st.db.trans[i])
        pts = np.asarray(st.db.surf_xyz[i])[np.asarray(st.db.surf_mask[i])]
        clouds.append(pts @ rot.T + trans)
    if clouds:
        pts = np.concatenate(clouds)
        z = pts[:, 2]
        zr = (z - z.min()) / max(float(z.max() - z.min()), 1e-6)
        color = np.stack([255 * zr, 64 + 0 * zr, 255 * (1 - zr)], axis=-1)
        write_ply(os.path.join(out_dir, "global_map.ply"), pts, color)

    export_factor_graph(slam, os.path.join(out_dir, "factor_graph.json"))
    render_factor_graph(slam, os.path.join(out_dir, "factor_graph.png"))
    if k:
        edges = [(i - 1, i) for i in range(1, k)]
        colors = [(150, 150, 150)] * len(edges)
        for f, col in ((st.graph.loops, (220, 40, 40)), (st.graph.priors, (40, 180, 60))):
            for e in range(int(f.count)):
                i, j = int(f.i[e]), int(f.j[e])
                if i < k and j < k:
                    edges.append((i, j))
                    colors.append(col)
        write_ply_graph(
            os.path.join(out_dir, "factor_graph.ply"),
            np.asarray(st.db.trans[:k]), edges, colors,
        )
    export_prior_observability(slam, out_dir)
    if k:
        outline = vehicle_outline(
            slam.vehicle, np.asarray(st.db.rot[k - 1]), np.asarray(st.db.trans[k - 1])
        )
        write_ply(os.path.join(out_dir, "vehicle_outline.ply"), outline)
