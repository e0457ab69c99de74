"""Loop closure: scan-context place recognition + ICP-verified factors.

JAX equivalent of the reference's SCManager
(/root/reference/include/scancontext/Scancontext.h) and backMapping's
loop-closure thread (/root/reference/src/backMapping.cpp:1904-2677).
"""

from .closure import (
    ICPResult,
    LoopFactor,
    assemble_loop_submap,
    detect_loop_distance,
    icp_point2point,
    verify_loop,
)
from .scancontext import (
    LoopDetection,
    ScanContextDB,
    add_descriptor,
    detect_loop,
    init_db,
    make_descriptor,
    ring_key,
    sector_key,
)

__all__ = [
    "ICPResult",
    "LoopFactor",
    "assemble_loop_submap",
    "detect_loop_distance",
    "icp_point2point",
    "verify_loop",
    "LoopDetection",
    "ScanContextDB",
    "add_descriptor",
    "detect_loop",
    "init_db",
    "make_descriptor",
    "ring_key",
    "sector_key",
]
