"""Edge-appearance descriptor: gradient-orientation-histogram (SIFT stand-in).

DELIBERATE DEVIATION from the reference: the reference calls OpenCV
cv::SIFT::compute on two orthogonally-shifted keypoints per edge
(src/Stereo_Matches.cpp:655-689, 691-787) - a host-side, dynamically-shaped
library call that cannot run inside a jitted device program. We fill the
same "appearance gate"
role with a batched 128-D gradient-orientation-histogram descriptor (the
same family of feature as SIFT):

  - 16x16 sample grid rotated to the keypoint orientation,
  - 4x4 spatial cells x 8 orientation bins (relative to the keypoint angle),
  - bilinear spatial binning + linear orientation binning,
  - Gaussian radial weighting (sigma = half window),
  - L2 normalize, clip at 0.2, renormalize, scale by 512 (OpenCV-compatible
    value range so the reference's distance thresholds 500/200 remain
    meaningful; they stay runtime-configurable in VOConfig).

Descriptors are computed for ALL edges of an image in one shot as gathers
over precomputed Sobel gradient maps - elementwise work. The keypoints are
the two orthogonally shifted points at +-8 px, matching
augment_Edge_Data (Stereo_Matches.cpp:669).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import patches as P


def _descriptor_at(gx_img, gy_img, x, y, theta,
                   n_samples: int, n_spatial: int, n_orient: int,
                   spacing: float, clip: float, scale: float):
    """128-D descriptor at one keypoint (vmapped). x, y, theta scalars."""
    half = (n_samples - 1) / 2.0
    offs = (jnp.arange(n_samples, dtype=jnp.float32) - half) * spacing
    ii = jnp.repeat(offs, n_samples)   # rotated-x offsets
    jj = jnp.tile(offs, n_samples)     # rotated-y offsets
    ct, st = jnp.cos(theta), jnp.sin(theta)
    sx = x + ct * ii - st * jj
    sy = y + st * ii + ct * jj

    gx = P.bilinear_sample_clamp(gx_img, sx, sy)
    gy = P.bilinear_sample_clamp(gy_img, sx, sy)
    mag = jnp.sqrt(gx * gx + gy * gy)
    ang = jnp.arctan2(gy, gx) - theta          # rotation-invariant

    # Gaussian radial weight over the window
    sigma = n_samples * spacing / 2.0
    w = jnp.exp(-(ii * ii + jj * jj) / (2.0 * sigma * sigma))
    mag = mag * w

    # Spatial bin coordinates in [0, n_spatial): bilinear over cells
    cell = n_samples / n_spatial
    u = (ii + half * spacing) / (cell * spacing)   # [0, n_spatial)
    v = (jj + half * spacing) / (cell * spacing)
    u = jnp.clip(u - 0.5, 0.0, n_spatial - 1.0)
    v = jnp.clip(v - 0.5, 0.0, n_spatial - 1.0)
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, n_spatial - 1)
    v1 = jnp.minimum(v0 + 1, n_spatial - 1)
    au = u - u0
    av = v - v0

    # Orientation bins with linear interpolation
    two_pi = 2.0 * jnp.pi
    ob = (ang % two_pi) / two_pi * n_orient
    o0 = jnp.floor(ob).astype(jnp.int32) % n_orient
    o1 = (o0 + 1) % n_orient
    ao = ob - jnp.floor(ob)

    D = n_spatial * n_spatial * n_orient
    desc = jnp.zeros((D,), jnp.float32)

    def flat(ui, vi, oi):
        return (ui * n_spatial + vi) * n_orient + oi

    for (ui, wu) in ((u0, 1 - au), (u1, au)):
        for (vi, wv) in ((v0, 1 - av), (v1, av)):
            for (oi, wo) in ((o0, 1 - ao), (o1, ao)):
                desc = desc.at[flat(ui, vi, oi)].add(mag * wu * wv * wo)

    norm = jnp.linalg.norm(desc)
    desc = desc / jnp.maximum(norm, 1e-7)
    desc = jnp.minimum(desc, clip)
    norm2 = jnp.linalg.norm(desc)
    return desc / jnp.maximum(norm2, 1e-7) * scale


def edge_descriptors(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                     n_samples: int = 16, n_spatial: int = 4,
                     n_orient: int = 8, spacing: float = 1.0,
                     clip: float = 0.2, scale: float = 512.0):
    """Descriptors at the two orthogonally shifted keypoints of each edge.

    x, y, theta: (N,). Returns (N, 2, D) float32. Mirrors the role of
    augment_Edge_Data (Stereo_Matches.cpp:655-689): keypoint angle = edge
    orientation, keypoints at +-shift_mag along the edge normal.
    """
    plus, minus = P.orthogonal_shifted_points(x, y, theta, shift_mag)
    fn = functools.partial(
        _descriptor_at, gx_img, gy_img,
        n_samples=n_samples, n_spatial=n_spatial, n_orient=n_orient,
        spacing=spacing, clip=clip, scale=scale)
    d_plus = jax.vmap(fn)(plus[:, 0], plus[:, 1], theta)
    d_minus = jax.vmap(fn)(minus[:, 0], minus[:, 1], theta)
    return jnp.stack([d_plus, d_minus], axis=1)


def edge_descriptors_tiled(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                           n_samples: int = 16, n_spatial: int = 4,
                           n_orient: int = 8, spacing: float = 1.0,
                           clip: float = 0.2, scale: float = 512.0,
                           tile: int = 40, stride: int = 8,
                           chunk: int = 8192, active=None):
    """Batched descriptor computation via tile-resident sampling and a
    factorized histogram einsum (no per-sample scatter-adds, which
    serialize on colliding bins). Numerically identical binning
    to `edge_descriptors`: separable hat weights over spatial cells
    reproduce the bilinear corner assignment (incl. boundary clamping),
    and a circular hat reproduces the two-bin orientation interpolation.

    x, y, theta: (N,). Returns FLAT (N, 2*D) bf16, [plus | minus]: one
    contiguous row per edge, so each downstream per-candidate gather
    moves one row and no tiled layout pads a size-2 minor dimension.
    """
    from edge_based_visual_odometry_tpu.ops import tiled_sampling as TS

    N = x.shape[0]
    S = n_samples * n_samples
    D = n_spatial * n_spatial * n_orient
    half = (n_samples - 1) / 2.0
    offs = (jnp.arange(n_samples, dtype=jnp.float32) - half) * spacing
    ii = jnp.repeat(offs, n_samples)
    jj = jnp.tile(offs, n_samples)
    sigma = n_samples * spacing / 2.0
    gauss = jnp.exp(-(ii * ii + jj * jj) / (2.0 * sigma * sigma))
    cell = n_samples / n_spatial
    u_base = jnp.clip((ii + half * spacing) / (cell * spacing) - 0.5,
                      0.0, n_spatial - 1.0)
    v_base = jnp.clip((jj + half * spacing) / (cell * spacing) - 0.5,
                      0.0, n_spatial - 1.0)
    sp_iota = jnp.arange(n_spatial, dtype=jnp.float32)
    Wu = jnp.maximum(0.0, 1.0 - jnp.abs(u_base[:, None] - sp_iota))  # (S,4)
    Wv = jnp.maximum(0.0, 1.0 - jnp.abs(v_base[:, None] - sp_iota))
    # Spatial bin weights are STATIC (sample offsets live in the rotated
    # frame), so the spatial part of the histogram is one constant (S, 16)
    # matrix and binning becomes a clean batched GEMM over samples.
    SP = jnp.einsum("su,sv->suv", Wu, Wv).reshape(S, n_spatial * n_spatial)
    or_iota = jnp.arange(n_orient, dtype=jnp.float32)
    atlas = TS.build_atlas(jnp.stack([gx_img, gy_img]), tile, stride)

    # keypoints: (2N,) plus/minus shifted
    from edge_based_visual_odometry_tpu.ops import patches as P

    plus, minus = P.orthogonal_shifted_points(x, y, theta, shift_mag)
    kx = jnp.concatenate([plus[:, 0], minus[:, 0]])
    ky = jnp.concatenate([plus[:, 1], minus[:, 1]])
    kt = jnp.concatenate([theta, theta])

    def run_chunk(args):
        kx_c, ky_c, kt_c = args
        ct = jnp.cos(kt_c)[:, None]
        st = jnp.sin(kt_c)[:, None]
        sx = kx_c[:, None] + ct * ii - st * jj
        sy = ky_c[:, None] + st * ii + ct * jj
        vals = TS.sample_atlas(atlas, kx_c, ky_c, sx, sy)
        gx = vals[:, 0]
        gy = vals[:, 1]
        mag = jnp.sqrt(gx * gx + gy * gy) * gauss
        ang = jnp.arctan2(gy, gx) - kt_c[:, None]
        ob = (ang % (2.0 * jnp.pi)) / (2.0 * jnp.pi) * n_orient
        dd = jnp.abs(ob[..., None] - or_iota)
        dd = jnp.minimum(dd, n_orient - dd)
        Wo = jnp.maximum(0.0, 1.0 - dd)                  # (b, S, 8)
        T = mag[..., None] * Wo                          # (b, S, 8)
        desc = jnp.einsum("sp,kso->kpo", SP, T)          # batched GEMM
        desc = desc.reshape(desc.shape[0], D)
        norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(norm, 1e-7)
        desc = jnp.minimum(desc, clip)
        norm2 = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        # store bf16: descriptor values are O(100) with ~1-unit tolerance
        # against the 500/200 gates; halves gather traffic downstream
        return (desc / jnp.maximum(norm2, 1e-7) * scale).astype(jnp.bfloat16)

    act2 = None if active is None else jnp.concatenate([active, active])
    out = TS.map_chunked(run_chunk, (kx, ky, kt), 2 * N, chunk, active=act2)
    return jnp.concatenate([out[:N], out[N:]], axis=1)


def min_cross_distance(desc_a, desc_b):
    """min of the 4 cross L2 distances between two 2-keypoint descriptors
    (Stereo_Matches.cpp:736-740). desc_a, desc_b: (..., 2, D)."""
    diff = desc_a[..., :, None, :] - desc_b[..., None, :, :]   # (..., 2, 2, D)
    d = jnp.linalg.norm(diff.astype(jnp.float32), axis=-1)
    return jnp.min(d, axis=(-2, -1))


def min_cross_distance_dot(desc_a, desc_b):
    """Same result as min_cross_distance via |a|^2 + |b|^2 - 2 a.b - the
    dot is a matmul and no (.., 2, 2, D) difference tensor is
    materialized. FLAT layout: desc_a (B, 2*D); desc_b (B, C, 2*D),
    [plus | minus] halves (edge_descriptors_tiled), sliced at D.
    """
    a = desc_a.astype(jnp.float32)
    b = desc_b.astype(jnp.float32)
    D = a.shape[-1] // 2
    a_h = jnp.stack([a[..., :D], a[..., D:]], axis=-2)   # (B, 2, D)
    d2s = []
    for j, b_h in enumerate((b[..., :D], b[..., D:])):
        a2 = jnp.sum(a_h * a_h, -1)                      # (B, 2)
        b2 = jnp.sum(b_h * b_h, -1)                      # (B, C)
        ab = jnp.einsum("bid,bcd->bci", a_h, b_h)        # (B, C, 2)
        d2s.append(a2[:, None, :] + b2[..., None] - 2.0 * ab)
    d2 = jnp.minimum(d2s[0], d2s[1])
    d2 = jnp.maximum(jnp.min(d2, axis=-1), 0.0)
    return jnp.sqrt(d2)
