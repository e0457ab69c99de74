"""rolo_tpu: a LiDAR odometry / SLAM engine in JAX.

A from-scratch JAX/XLA re-design with the capabilities of ROLO-SLAM:
rotation-optimized rot-GICP front-end, scan-to-submap back-end,
scan-context loop closure, ground-contact priors, pose-graph optimization,
and a pose ESKF — implemented as pure functions over fixed-shape arrays,
batched and sharded with pjit over device meshes.
"""

import jax as _jax

# This library is geometry, not ML: every matmul needs full f32 products.
# On the H100, XLA compiles an f32 dot at the "default" and "high"
# precisions to TF32 (a 10-bit mantissa; relative error ~7e-4 vs ~1.5e-7
# at "highest", measured on the card). A point at 40 m then picks up
# centimetres of noise in every rotation product, and the k-NN distance
# matrix |q|^2 - 2 q.x + |x|^2 metres^2 of it: at "high" the scan-to-submap
# 5-NN returned neighbours 3.5 m^2 beyond the true 5th and the covariance
# moments were off by 3x (chip_smoke.py's kernels phase; PERF.md). So the
# process-wide default is "highest".
#
# SIDE EFFECT (deliberate, process-global): importing rolo_tpu raises the
# default matmul precision for the WHOLE host process, including unrelated
# JAX code (a colocated bf16 ML model will run f32 matmuls everywhere).
# Scoping per-matmul would require a precision= argument at every one of
# the library's >100 contractions and is easy to miss in new code — one
# global default is the safe direction for a geometry library. Hosts that
# need reduced precision elsewhere can wrap those regions in
# `jax.default_matmul_precision("default")`.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import RoloConfig, load_config

__version__ = "0.1.0"
__all__ = ["RoloConfig", "load_config", "__version__"]
