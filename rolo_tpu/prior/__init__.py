"""Ground-contact prior stack.

JAX equivalent of the reference's prior_pose_node + pose_solver +
performPriorAssociation (/root/reference/src/prior_pose/,
/root/reference/src/backMapping.cpp:1943-2158).
"""

from .association import (
    PriorFactor,
    PriorObservation,
    PriorQueue,
    associate_prior,
    compute_prior,
    init_queue,
    push_prior,
)
from .ground import (
    GroundMap,
    average_height_at,
    contact_point,
    extract_patch,
    fit_local_surface,
    from_cloud,
    nearest_point_xy,
)
from .vehicle import SolverResult, VehicleModel, from_config, solve_pose

__all__ = [
    "PriorFactor",
    "PriorObservation",
    "PriorQueue",
    "associate_prior",
    "compute_prior",
    "init_queue",
    "push_prior",
    "GroundMap",
    "average_height_at",
    "contact_point",
    "extract_patch",
    "fit_local_surface",
    "from_cloud",
    "nearest_point_xy",
    "SolverResult",
    "VehicleModel",
    "from_config",
    "solve_pose",
]
