"""Runtime: host IO, metrics, and the full SLAM system driver.

JAX equivalent of the reference's launch/orchestration layer
(/root/reference/launch/) plus its export paths
(/root/reference/src/backMapping.cpp:1500-1608, 2679-2699).
"""

from .io import (
    load_checkpoint,
    read_kitti_bin,
    read_pcd,
    read_tum,
    save_checkpoint,
    write_g2o,
    write_pcd,
    write_tum,
)
from .metrics import ATEResult, associate_by_time, ate, rpe, umeyama_alignment
from .profiling import StageTimers, device_trace
from .slam import SlamSystem, infer_rel_time, infer_rings

__all__ = [
    "load_checkpoint",
    "read_kitti_bin",
    "read_pcd",
    "read_tum",
    "save_checkpoint",
    "write_g2o",
    "write_pcd",
    "write_tum",
    "ATEResult",
    "associate_by_time",
    "ate",
    "rpe",
    "umeyama_alignment",
    "SlamSystem",
    "StageTimers",
    "device_trace",
    "infer_rel_time",
    "infer_rings",
]
