"""Edge-based stereo visual odometry in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
Brown-LEMS/Edge_Based_Visual_Odometry (C++17/OpenMP reference):

  - Third-order subpixel edge detection (TOED) as fused XLA ops over
    2x-upsampled gradient fields (reference: src/toed/cpu_toed.cpp).
  - Stereo edge matching as a masked fixed-shape filter cascade over
    (N_left, MAX_CAND) candidate tensors (reference: src/Stereo_Matches.cpp).
  - Temporal quad matching KF<->CF (reference: src/Temporal_Matches.cpp).
  - Constraint-gated 2-point RANSAC pose solver, fully vectorized
    (reference: src/MotionTracker.cpp).
  - Dataset iterators for KITTI / EuRoC / ETH3D stereo / ETH3D SLAM
    (reference: src/Stereo_Iterator.cpp, src/Dataset.cpp).

Everything on the device side is fixed-shape, masked, and jit-compiled;
multi-device scaling uses jax.sharding over a Mesh (frames/tiles axis), not
the reference's OpenMP threads.
"""

import os as _os

import jax as _jax

# Subpixel edge geometry needs true f32 accumulation. On a GPU an f32
# matmul/conv left at the default precision runs on the tensor cores in
# TF32 (10-bit mantissa), which costs ~5e-3 absolute error in pose and
# triangulation math. "highest" keeps every product that does not name a
# precision in full f32; hot kernels that tolerate less opt in explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR wins when set
# (JAX reads it itself); otherwise one fixed directory inside the checkout,
# so every process of this checkout finds what an earlier one compiled.
CACHE_DIR_DEFAULT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR_DEFAULT)

from edge_based_visual_odometry_tpu.config import VOConfig, CameraConfig, StereoRig

__version__ = "0.1.0"

__all__ = ["VOConfig", "CameraConfig", "StereoRig", "__version__"]
