"""Pod-scale parallelism: device meshes + batched SLAM workloads.

The explicit account of the reference's parallelism inventory
(SURVEY.md section 2.7): process pipelining, OpenMP loops, and the pub/sub
bus collapse into jitted programs; the *new* axis the reference lacks —
batch parallelism over a mesh — lives here.
"""

from .batch import (
    ShardedRegistrationInputs,
    odometry_batch,
    prior_solve_batch,
    registration_batch,
    shard_registration_inputs,
)
from .mesh import (
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from .spmd import register_scan_pair_spmd

__all__ = [
    "register_scan_pair_spmd",
    "ShardedRegistrationInputs",
    "odometry_batch",
    "prior_solve_batch",
    "registration_batch",
    "shard_registration_inputs",
    "batch_sharding",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
]
