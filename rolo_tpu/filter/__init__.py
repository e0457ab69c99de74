"""State estimation: manifold pose ESKF + odometry fusion + the generic
manifold-EKF toolkit.

JAX equivalent of the reference's PoseESEKF / IKFoM stack
(/root/reference/include/rolo/eskf/) and TransformFusion
(/root/reference/src/lidarOdometry.cpp:47-323). `manifold` is the generic
IKFoM analog (declare any vect/SO3/S2 composition; Jacobians by autodiff
through boxminus); `eskf` is the specialized 18-DoF pose instantiation the
hot path uses, pinned against the generic machinery by tests.
"""

from . import manifold
from .eskf import (
    ESKFState,
    FutureRollout,
    init_filter,
    predict,
    process_measurement,
    state_predict,
    state_propagate,
    update_iterated,
)
from .fusion import (
    FusedPose,
    FusionState,
    FuturePrediction,
    fused_pose,
    init_fusion,
    on_front_odometry,
    on_mapping_odometry,
    predict_future,
)

__all__ = [
    "manifold",
    "ESKFState",
    "FutureRollout",
    "init_filter",
    "predict",
    "process_measurement",
    "state_predict",
    "state_propagate",
    "update_iterated",
    "FusedPose",
    "FusionState",
    "FuturePrediction",
    "fused_pose",
    "init_fusion",
    "on_front_odometry",
    "on_mapping_odometry",
    "predict_future",
]
