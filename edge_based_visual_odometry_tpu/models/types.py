"""Shared device-side pytree types for the VO pipeline."""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from edge_based_visual_odometry_tpu.config import StereoRig


class RigArrays(NamedTuple):
    """Stereo rig constants as device arrays (derived from StereoRig;
    reference equivalents: Dataset camera_info, src/Dataset.cpp:77-112)."""

    K_left: jnp.ndarray       # (3, 3)
    K_right: jnp.ndarray
    K_left_inv: jnp.ndarray
    K_right_inv: jnp.ndarray
    R21: jnp.ndarray          # (3, 3) left -> right
    T21: jnp.ndarray          # (3,)
    F21: jnp.ndarray          # (3, 3) left point -> right epipolar line
    F12: jnp.ndarray

    @staticmethod
    def from_rig(rig: StereoRig, dtype=jnp.float32) -> "RigArrays":
        return RigArrays(
            K_left=jnp.asarray(rig.left.K, dtype),
            K_right=jnp.asarray(rig.right.K, dtype),
            K_left_inv=jnp.asarray(rig.left.K_inv, dtype),
            K_right_inv=jnp.asarray(rig.right.K_inv, dtype),
            R21=jnp.asarray(rig.R21_np, dtype),
            T21=jnp.asarray(rig.T21_np, dtype),
            F21=jnp.asarray(rig.F21, dtype),
            F12=jnp.asarray(rig.F12, dtype),
        )


class FrameData(NamedTuple):
    """Per-frame device data (reference StereoFrame,
    include/Stereo_Iterator.h:71-95). Images are undistorted grayscale
    float32 (H, W); gradients are Sobel/8 (utility.h:131-141)."""

    left: jnp.ndarray
    right: jnp.ndarray
    left_gx: jnp.ndarray
    left_gy: jnp.ndarray
    right_gx: jnp.ndarray
    right_gy: jnp.ndarray


class StereoMates(NamedTuple):
    """Finalized stereo edge pairs (reference final_stereo_edge_pair,
    include/Dataset.h:291-309), as fixed-capacity SoA."""

    left_x: jnp.ndarray        # (M,)
    left_y: jnp.ndarray
    left_theta: jnp.ndarray
    right_x: jnp.ndarray
    right_y: jnp.ndarray
    right_theta: jnp.ndarray
    # flat [plus | minus] patch layout: one contiguous 2*P*P row per mate,
    # so each temporal per-candidate patch gather moves one row, and no
    # tiled layout pads a size-2 minor dimension
    left_patches: jnp.ndarray   # (M, 2*P*P)  [plus | minus]
    right_patches: jnp.ndarray  # (M, 2*P*P)
    left_patch_ok: jnp.ndarray  # (M, 2) bool
    right_patch_ok: jnp.ndarray
    left_desc: jnp.ndarray      # (M, 2*D) bf16 flat [plus | minus]
    right_desc: jnp.ndarray     # (M, 2*D)
    gamma: jnp.ndarray          # (M, 3) triangulated 3D point, left cam
    gamma_gt: jnp.ndarray       # (M, 3) GT-disparity 3D point (eval path)
    gt_x: jnp.ndarray           # (M,) GT right location (-1 without GT)
    gt_y: jnp.ndarray
    is_tp: jnp.ndarray          # (M,) bool (eval path)
    valid: jnp.ndarray          # (M,) bool
    count: jnp.ndarray          # () int32
