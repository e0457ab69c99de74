"""ctypes bindings for the native host library (cpp/rolo_host.cpp).

The reference is a native C++ application; this build keeps its compute on
the accelerator but keeps ingest native: PCD / KITTI decode, rosbag indexing +
sensor_msgs parsing, and a background prefetch queue. The library is built
on demand (g++ -O3 -shared) and every entry point has a pure-numpy
fallback in runtime/io.py, so the package works without a toolchain.
"""

from .host import (
    BagReader,
    ScanPrefetchQueue,
    is_available,
    library_path,
    read_kitti_bin_native,
    read_pcd_native,
)

__all__ = [
    "BagReader",
    "ScanPrefetchQueue",
    "is_available",
    "library_path",
    "read_kitti_bin_native",
    "read_pcd_native",
]
