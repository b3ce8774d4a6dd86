"""Third-order edge detection (TOED) as fused XLA ops.

A fixed-shape re-design of the reference detector
(src/toed/cpu_toed.cpp:66-582):

  1. `toed_gradient_field`  - the 9 Gaussian-derivative convolutions at 4
     half-pixel phases (reference convolve_img, cpu_toed.cpp:122-376). The
     reference runs a quadruple scalar loop per pixel under OpenMP; here it
     is one batched convolution producing a (2H, 2W) upsampled field of
     (Ix, Iy, |grad|, third-order orientation).
  2. `toed_nms_subpixel`    - directional non-maximum suppression over 8
     gradient quadrants with linear neighbor interpolation + Fisher-Naidu
     parabola subpixel fit (reference non_maximum_suppresion,
     cpu_toed.cpp:386-513), fully vectorized elementwise work.
  3. `extract_edges`        - masked raster-order compaction of surviving
     subpixel edges into a fixed-capacity EdgeList (reference's serial
     output pass, cpu_toed.cpp:525-575), including the (p - 1) / 2
     interp->image coordinate mapping (cpu_toed.cpp:538-542) and the 10 px
     border rejection (cpu_toed.cpp:553-554).

Everything is float32 and fixed-shape; `detect_edges` is the jitted
composition.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from edge_based_visual_odometry_tpu.ops import filters
from edge_based_visual_odometry_tpu.ops import sortfree as SF


class EdgeList(NamedTuple):
    """Fixed-capacity padded edge list (replaces std::vector<Edge>,
    reference include/toed/cpu_toed.hpp:26-48)."""

    x: jnp.ndarray        # (MAX_EDGES,) subpixel x, image coords
    y: jnp.ndarray        # (MAX_EDGES,) subpixel y, image coords
    theta: jnp.ndarray    # (MAX_EDGES,) third-order orientation, radians
    mag: jnp.ndarray      # (MAX_EDGES,) subpixel gradient magnitude
    valid: jnp.ndarray    # (MAX_EDGES,) bool
    count: jnp.ndarray    # () int32, number of valid edges


def _shift_add_conv_1d(x: jnp.ndarray, taps, axis: int) -> jnp.ndarray:
    """Correlation out[i] = sum_a taps[a] * x[i + a - C] with zero padding,
    as an unrolled shift-and-add - pure elementwise FMA work that XLA fuses
    into a handful of passes (a 1-input-channel 2D conv is degenerate for
    conv libraries and matrix units: K=1 contraction)."""
    K = len(taps)
    C = (K - 1) // 2
    pad_widths = [(0, 0), (0, 0)]
    pad_widths[axis] = (C, C)
    p = jnp.pad(x, pad_widths)
    size = x.shape[axis]
    acc = None
    for a in range(K):
        t = float(taps[a])
        if t == 0.0:
            continue
        s = jax.lax.dynamic_slice_in_dim(p, a, size, axis=axis)
        acc = t * s if acc is None else acc + t * s
    return acc


def _windowed_conv_1d_multi(x: jnp.ndarray, taps_matrix: np.ndarray,
                            axis: int) -> jnp.ndarray:
    """All O correlations out[o, i] = sum_a taps[o, a] * x[.., i + a - C, ..]
    in ONE einsum over a stacked shift window.

    The per-tap shift-and-add (above) emits ~900 small slice+FMA ops per
    image, each with its own launch overhead; stacking the K shifted views
    once and contracting in a matmul collapses that to one materialized
    (K, ...) window + one matmul per pass. HIGHEST precision keeps f32
    accuracy (the TOED parity tests gate this; TF32 would not pass).

    x: (...); taps_matrix: (O, K) numpy. Returns (O, *x.shape).
    """
    O, K = taps_matrix.shape
    C = (K - 1) // 2
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (C, C)
    p = jnp.pad(x, pad_widths)
    size = x.shape[axis]
    window = jnp.stack([jax.lax.dynamic_slice_in_dim(p, a, size, axis=axis)
                        for a in range(K)])            # (K, *x.shape)
    taps = jnp.asarray(np.asarray(taps_matrix, np.float32))
    return jnp.einsum("ok,k...->o...", taps, window,
                      precision=jax.lax.Precision.HIGHEST)


def toed_gradient_field(img: jnp.ndarray, kernel_size: int = 17,
                        sigma: float = 2.0):
    """Compute the 2x-upsampled (Ix, Iy, |grad|, orientation) field.

    img: (H, W) float32 grayscale in [0, 255].
    Returns (Ix, Iy, grad_mag, orient), each (2H, 2W) float32.

    Uses the separable factorization (ops/filters.toed_separable_taps):
    12 column passes + 36 row passes of 19-tap shift-and-add, ~900 FMAs
    per pixel vs the reference's ~12300 MACs/pixel scalar loop
    (cpu_toed.cpp:180-364).
    """
    H, W = img.shape
    col_taps, row_select, row_taps = filters.toed_separable_taps(
        kernel_size, sigma)
    x = img.astype(jnp.float32)
    # column pass: all 12 column filters in one windowed einsum
    cols = _windowed_conv_1d_multi(x, np.asarray(col_taps, np.float32),
                                   axis=0)             # (12, H, W)
    # row pass: one windowed einsum per source column (each column feeds
    # 2-4 of the 36 outputs); ~13 device ops total vs ~900 shift-adds
    row_select = [int(s) for s in row_select]
    outs = [None] * 36
    for c in sorted(set(row_select)):
        o_ids = [o for o in range(36) if row_select[o] == c]
        taps_c = np.asarray([row_taps[o] for o in o_ids], np.float32)
        res = _windowed_conv_1d_multi(cols[c], taps_c, axis=1)
        for i, o in enumerate(o_ids):
            outs[o] = res[i]
    d = jnp.stack(outs).reshape(4, 9, H, W)         # phases x derivatives

    fx, fy = d[:, 0], d[:, 1]
    fxx, fxy, fyy = d[:, 2], d[:, 3], d[:, 4]
    fxxy, fxyy, fxxx, fyyy = d[:, 5], d[:, 6], d[:, 7], d[:, 8]

    grad_mag = jnp.sqrt(fx * fx + fy * fy)
    # Third-order direction (cpu_toed.cpp:224-229). The reference normalizes
    # by the magnitude before atan2; atan2 is scale-invariant so we skip it.
    to_ix = (fx * (2 * fxx * fxx + 2 * fxy * fxy)
             + fy * (2 * fxx * fxy + 2 * fyy * fxy)
             + 2 * fx * fy * fxxy + fy * fy * fxyy + fx * fx * fxxx)
    to_iy = (fx * (2 * fxx * fxy + 2 * fyy * fxy)
             + fy * (2 * fyy * fyy + 2 * fxy * fxy)
             + 2 * fx * fy * fxyy + fx * fx * fxxy + fy * fy * fyyy)
    orient = jnp.arctan2(to_ix, -to_iy)

    def interleave(phases):
        # phases: (4, H, W) in order (0,0),(0,1),(1,0),(1,1) -> (2H, 2W)
        t = phases.reshape(2, 2, H, W)              # (sy, sx, i, j)
        t = jnp.transpose(t, (2, 0, 3, 1))          # (i, sy, j, sx)
        return t.reshape(2 * H, 2 * W)

    return (interleave(fx), interleave(fy),
            interleave(grad_mag), interleave(orient))


def _neighbor(m: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """m shifted so that out[i, j] = m[i + di, j + dj] (zeros outside)."""
    p = jnp.pad(m, ((1, 1), (1, 1)))
    H, W = m.shape
    return jax.lax.dynamic_slice(p, (1 + di, 1 + dj), (H, W))


def toed_nms_subpixel(Ix, Iy, grad_mag, orient, border: int = 10,
                      grad_mag_min: float = 2.0):
    """Directional NMS + parabola subpixel localization.

    Vectorized re-design of cpu_toed.cpp:386-513. Returns
    (subpix_x, subpix_y, subpix_mag, valid), each (2H, 2W); subpix
    coordinates are in interp-grid units (the (p-1)/2 mapping is applied at
    extraction, as in the reference).
    """
    iH, iW = grad_mag.shape
    g = grad_mag
    nd_x = Ix / g
    nd_y = Iy / g

    # 8 neighbor magnitude maps
    n = {(di, dj): _neighbor(g, di, dj)
         for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)}

    ax, ay = jnp.abs(Ix), jnp.abs(Iy)
    px, py = Ix >= 0, Iy >= 0  # sign predicates (cpu_toed.cpp:418-477)

    # (quadrant mask, slope, fp terms, fm terms); all branch math mirrors
    # the reference's 8 quadrants exactly.
    sl_yx = nd_y / nd_x
    sl_xy = nd_x / nd_y
    quads = [
        (px & py & (Ix >= Iy),        sl_yx,  (n[(0, 1)],  n[(1, 1)]),  (n[(0, -1)], n[(-1, -1)])),
        (px & py & (Ix < Iy),         sl_xy,  (n[(1, 0)],  n[(1, 1)]),  (n[(-1, 0)], n[(-1, -1)])),
        (~px & py & (ax < Iy),        -sl_xy, (n[(1, 0)],  n[(1, -1)]), (n[(-1, 0)], n[(-1, 1)])),
        (~px & py & (ax >= Iy),       -sl_yx, (n[(0, -1)], n[(1, -1)]), (n[(0, 1)],  n[(-1, 1)])),
        (~px & ~py & (ax >= ay),      sl_yx,  (n[(0, -1)], n[(-1, -1)]), (n[(0, 1)], n[(1, 1)])),
        (~px & ~py & (ax < ay),       sl_xy,  (n[(-1, 0)], n[(-1, -1)]), (n[(1, 0)], n[(1, 1)])),
        (px & ~py & (Ix < ay),        -sl_xy, (n[(-1, 0)], n[(-1, 1)]), (n[(1, 0)],  n[(1, -1)])),
        (px & ~py & (Ix >= ay),       -sl_yx, (n[(0, 1)],  n[(-1, 1)]), (n[(0, -1)], n[(1, -1)])),
    ]

    slope = jnp.zeros_like(g)
    fp = jnp.zeros_like(g)
    fm = jnp.zeros_like(g)
    for mask, sl, (fp_a, fp_b), (fm_a, fm_b) in quads:
        m = mask
        slope = jnp.where(m, sl, slope)
        fp = jnp.where(m, fp_a * (1 - sl) + fp_b * sl, fp)
        fm = jnp.where(m, fm_a * (1 - sl) + fm_b * sl, fm)

    # Relaxed max test (cpu_toed.cpp:481-483)
    is_max = ((g > fm) & (g >= fp)) | ((g >= fm) & (g > fp))

    # Parabola fit (cpu_toed.cpp:487-494)
    s = jnp.sqrt(1.0 + slope * slope)
    A = (fm + fp - 2.0 * g) / (2.0 * s * s)
    B = (fp - fm) / (2.0 * s)
    s_star = -B / (2.0 * A)
    max_f = A * s_star * s_star + B * s_star + g
    within_pixel = jnp.abs(s_star) <= jnp.sqrt(2.0)

    jj = jax.lax.broadcasted_iota(jnp.float32, (iH, iW), 1)
    ii = jax.lax.broadcasted_iota(jnp.float32, (iH, iW), 0)
    subpix_x = jj + s_star * nd_x
    subpix_y = ii + s_star * nd_y
    sub_gx = max_f * nd_x
    sub_gy = max_f * nd_y
    subpix_mag = jnp.sqrt(sub_gx * sub_gx + sub_gy * sub_gy)

    in_border = ((ii >= border) & (ii < iH - border)
                 & (jj >= border) & (jj < iW - border))
    grad_ok = g > grad_mag_min
    dir_ok = ~((ax < 1e-5) & (ay < 1e-5))   # cpu_toed.cpp:410 (10e-6)
    valid = in_border & grad_ok & dir_ok & is_max & within_pixel
    return subpix_x, subpix_y, subpix_mag, valid


def extract_edges(subpix_x, subpix_y, subpix_mag, orient, valid,
                  img_height: int, img_width: int,
                  max_edges: int, border: int = 10) -> EdgeList:
    """Masked raster-order compaction to a fixed EdgeList.

    Reproduces the reference's serial output pass (cpu_toed.cpp:530-575):
    raster scan over the interp grid, map interp coords to image coords via
    (p - 1) / 2, keep edges strictly inside the `border`-pixel margin.
    Raster ordering keeps Edge.index stable and reference-compatible.
    """
    ex = (subpix_x - 1.0) * 0.5
    ey = (subpix_y - 1.0) * 0.5
    keep = valid & (ex > border) & (ex < img_width - border) \
                 & (ey > border) & (ey < img_height - border)

    flat_keep = keep.reshape(-1)
    csum = SF.cumsum_i32(flat_keep)          # inclusive prefix counts
    count = jnp.minimum(csum[-1], max_edges).astype(jnp.int32)
    # Rank -> linear-index routing WITHOUT a scatter: the kept element of
    # raster rank k sits at the first flat index where the inclusive keep
    # count reaches k+1, i.e. searchsorted(csum, k+1, 'left'). csum is
    # monotone, so this is ~log2(2H*2W) rounds of (max_edges,)-sized
    # gathers instead of a full (2H*2W)-update scatter stream. Exact:
    # identical kept entries and ordering; ranks >= count resolve past the
    # array end and are masked by slot_ok below.
    ranks = jnp.arange(1, max_edges + 1, dtype=jnp.int32)
    lin_of = jnp.searchsorted(csum, ranks, side="left").astype(jnp.int32)
    slot_ok = jnp.arange(max_edges, dtype=jnp.int32) < count

    def pick(v):
        return jnp.where(slot_ok, v.reshape(-1)[lin_of], 0.0)

    out_x = pick(ex.astype(jnp.float32))
    out_y = pick(ey.astype(jnp.float32))
    out_t = pick(orient.astype(jnp.float32))
    out_m = pick(subpix_mag.astype(jnp.float32))
    return EdgeList(out_x, out_y, out_t, out_m, slot_ok, count)


@functools.partial(jax.jit, static_argnames=(
    "kernel_size", "sigma", "max_edges", "border"))
def detect_edges(img: jnp.ndarray, kernel_size: int = 17, sigma: float = 2.0,
                 grad_mag_min: float = 2.0, max_edges: int = 32768,
                 border: int = 10) -> EdgeList:
    """Full TOED: image -> EdgeList (reference get_Third_Order_Edges,
    cpu_toed.cpp:66-77)."""
    H, W = img.shape
    Ix, Iy, mag, orient = toed_gradient_field(img, kernel_size, sigma)
    sx, sy, smag, valid = toed_nms_subpixel(
        Ix, Iy, mag, orient, border=border, grad_mag_min=grad_mag_min)
    # No optimization_barrier on the NMS maps: an isolated detect_edges
    # suggests the extraction recomputes the NMS chain, but inside the
    # composed per-frame program XLA's fusion choices hold, and forcing 5
    # (2H, 2W) materializations made the whole pipeline slower.
    return extract_edges(sx, sy, smag, orient, valid, H, W, max_edges, border)
