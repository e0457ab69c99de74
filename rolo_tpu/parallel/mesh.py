"""Device-mesh helpers for pod-scale batching.

The reference's distribution story is five OS processes on a TCPROS bus on
one machine (SURVEY.md section 2.7); its per-scan compute never exceeds one
CPU. This build's scaling axis is *batch*: thousands of concurrent
scan-pair registrations, odometry sequences, pose-graph solves, and prior
solves sharded over a `jax.sharding.Mesh`. These helpers standardize mesh
construction and pytree sharding so every batched entry point in
parallel/batch.py works identically on 1 card, several cards, or a CPU mesh
of virtual devices (tests/conftest.py).

Axis convention: ("host", "batch") for multi-host pods — batch sharding
rides ICI within a slice, host sharding rides DCN; single-slice runs use a
1D ("batch",) mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("batch",),
    axis_sizes: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first `n_devices` devices.

    With one axis the mesh is 1D; with several, `axis_sizes` must multiply
    to the device count (e.g. axis_names=("host", "batch"),
    axis_sizes=(n_hosts, devices_per_host))."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if axis_sizes is None:
        axis_sizes = (n_devices,) if len(axis_names) == 1 else None
    if axis_sizes is None:
        raise ValueError("axis_sizes required for multi-axis meshes")
    return Mesh(devices.reshape(tuple(axis_sizes)), axis_names=tuple(axis_names))


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> NamedSharding:
    """Sharding that splits axis 0 of an array across `axis_name`."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(pytree, mesh: Mesh, axis_name: str = "batch"):
    """Place every leaf with axis 0 sharded over `axis_name` — a single
    mesh axis or a tuple of axes, e.g. ("host", "batch") to split over the
    whole pod (leaves whose leading dimension is not divisible by the
    axis size are replicated)."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    axis_size = 1
    for nm in names:
        axis_size *= mesh.shape[nm]
    sharded = batch_sharding(mesh, axis_name)
    repl = replicated(mesh)

    def place(x):
        if hasattr(x, "shape") and x.ndim >= 1 and x.shape[0] % axis_size == 0 and x.shape[0] > 0:
            return jax.device_put(x, sharded)
        return jax.device_put(x, repl)

    return jax.tree_util.tree_map(place, pytree)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (batch padding for even sharding)."""
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Multi-host (DCN) entry points
# ---------------------------------------------------------------------------

def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Bootstrap `jax.distributed` for a multi-host pod. Call once per host
    process before any other JAX call; afterwards jax.devices() spans the
    whole pod and the meshes below shard across hosts over DCN.

    With no arguments, reads the standard env/cluster auto-detection
    (JAX_COORDINATOR_ADDRESS etc.). Returns True when running multi-process
    after the call, False when single-process (no-op — the local mesh path
    is identical, which is what the tests exercise)."""
    try:
        if coordinator_address or num_processes:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        elif jax.process_count() == 1:
            # try env-based auto-detect; harmless no-op outside clusters
            try:
                jax.distributed.initialize()
            except Exception:
                pass
    except RuntimeError:
        pass  # already initialized
    return jax.process_count() > 1


def make_pod_mesh(
    n_hosts: Optional[int] = None,
    devices_per_host: Optional[int] = None,
    axis_names: Sequence[str] = ("host", "batch"),
) -> Mesh:
    """2D ("host", "batch") mesh: axis 0 over host groups (DCN), axis 1
    over the devices within each group (ICI). Defaults to
    jax.process_count() x local device count; on a single process, pass
    explicit sizes to emulate a pod topology on virtual devices."""
    devices = np.asarray(jax.devices())
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    if devices_per_host is None:
        devices_per_host = len(devices) // n_hosts
    n = n_hosts * devices_per_host
    return Mesh(devices[:n].reshape(n_hosts, devices_per_host), axis_names=tuple(axis_names))


def pod_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batch axis 0 split over BOTH mesh axes (host-major): each host group
    gets a contiguous batch block, split again across its devices."""
    return NamedSharding(mesh, P(tuple(mesh.axis_names)))


def shard_batch_pod(pytree, mesh: Mesh):
    """shard_batch over a 2D pod mesh: leaves with a leading axis divisible
    by the total device count are split over (host, batch), others
    replicated."""
    total = int(np.prod(list(mesh.shape.values())))
    sharded = pod_batch_sharding(mesh)
    repl = replicated(mesh)

    def place(x):
        if hasattr(x, "shape") and x.ndim >= 1 and x.shape[0] % total == 0 and x.shape[0] > 0:
            return jax.device_put(x, sharded)
        return jax.device_put(x, repl)

    return jax.tree_util.tree_map(place, pytree)
