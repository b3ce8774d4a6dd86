"""Tile-resident bilinear sampling in place of random image gathers.

The photometric stages need O(10^8) bilinear samples per frame. Naive
`img[y, x]` lowers each to element gathers; this module restructures
image sampling in two steps instead:

  1. `gather_tiles`: one vmapped dynamic_slice per candidate fetches a
     TxT tile around its anchor - a slice-gather of contiguous rows.
  2. `bilinear_sample_tiles`: arbitrary subpixel samples WITHIN the tile
     are evaluated with separable hat-function weight matrices and two
     batched einsums - matmuls instead of random access:
       value[b, s] = sum_{r, c} hat(ry[b,s]-r) * tile[b,r,c] * hat(rx[b,s]-c)

The hat-function product is exactly bilinear interpolation for in-tile
points; coordinates are clamped to the tile, which reproduces the
reference's border-clamp sampling (util_bilinear_Sample_F,
include/utility.h:159-172) whenever the tile touches the image border,
and bounds Gauss-Newton travel to the tile otherwise (documented
deviation; tiles are sized with travel margin).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tile_origins(cx, cy, tile: int, height: int, width: int):
    """Top-left origins of TxT tiles centered near (cx, cy), clipped to
    stay inside the image."""
    oy = jnp.clip(jnp.floor(cy).astype(jnp.int32) - tile // 2 + 1,
                  0, height - tile)
    ox = jnp.clip(jnp.floor(cx).astype(jnp.int32) - tile // 2 + 1,
                  0, width - tile)
    return ox, oy


def gather_tiles(imgs: jnp.ndarray, ox: jnp.ndarray, oy: jnp.ndarray,
                 tile: int) -> jnp.ndarray:
    """Fetch TxT tiles from (C, H, W) stacked maps at per-candidate
    origins. Returns (B, C, T, T)."""
    def one(oy_i, ox_i):
        return jax.lax.dynamic_slice(
            imgs, (0, oy_i, ox_i), (imgs.shape[0], tile, tile))
    return jax.vmap(one)(oy, ox)


def bilinear_sample_tiles(tiles: jnp.ndarray, ox, oy, xs, ys,
                          precision=jax.lax.Precision.HIGH,
                          grad_precision=None,
                          weight_split: bool = False):
    """Bilinear-sample (B, C, T, T) tiles at absolute coords (B, S).

    Returns (B, C, S). Coordinates are clamped to the tile interior.

    Precision policy. On an NVIDIA H100 an f32 einsum at HIGH or DEFAULT
    runs on the tensor cores in TF32 (~1.4e-4 relative error on these
    contractions, against ~3e-7 at HIGHEST). Value channels run at
    `precision` (HIGH). `grad_precision`, when set, applies to channels
    1..C-1 (the gradient maps in the GN layout [img, gx, gy]): gradients
    only scale the Gauss-Newton step - they cancel out of the converged
    fixed point - so they tolerate the least precise mode. Both choices
    were made for a device without TF32 and are kept until the GPU
    speed/pose-error A/B.

    `weight_split`: value-channel path for INTEGER-VALUED images (the
    production path: PNG/uint8 sources; 0..255 is exact in bf16). The big
    column contraction runs as TWO bf16 einsums with the hat weights
    split hi/lo (w = bf16(w) + bf16(w - bf16(w))), meant to be exact to
    ~2^-16. XLA's CPU backend keeps it so (~1.5e-6 relative); on the H100
    the pair measured ~1.0e-3 relative, i.e. bf16-level, about 0.25 gray
    at full scale. Non-integer sources (e.g. EuRoC's host-undistorted
    frames) should keep it off: tile rounding adds ~0.2 gray of noise.
    """
    B, C, T, _ = tiles.shape
    rx = jnp.clip(xs - ox[:, None].astype(xs.dtype), 0.0, T - 1.0)
    ry = jnp.clip(ys - oy[:, None].astype(ys.dtype), 0.0, T - 1.0)
    iota = jnp.arange(T, dtype=xs.dtype)
    # hat weights: exactly the two bilinear corner weights per axis
    w_row = jnp.maximum(0.0, 1.0 - jnp.abs(ry[..., None] - iota))  # (B,S,T)
    w_col = jnp.maximum(0.0, 1.0 - jnp.abs(rx[..., None] - iota))  # (B,S,T)

    def contract(tl, prec):
        # contract the column axis first: (B,S,U)x(B,c,T,U) -> (B,c,T,S)
        # keeps the LARGER sample axis minor in the output, then the row
        # weights reduce over T
        p = jnp.einsum("bsu,bctu->bcts", w_col, tl, precision=prec)
        return jnp.einsum("bst,bcts->bcs", w_row, p, precision=prec)

    def contract_split(tl):
        w_hi = w_col.astype(jnp.bfloat16)
        w_lo = (w_col - w_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        t_bf = tl.astype(jnp.bfloat16)
        prec = jax.lax.Precision.DEFAULT
        p = (jnp.einsum("bsu,bctu->bcts", w_hi, t_bf, precision=prec,
                        preferred_element_type=jnp.float32)
             + jnp.einsum("bsu,bctu->bcts", w_lo, t_bf, precision=prec,
                          preferred_element_type=jnp.float32))
        # the row contraction is ~T times smaller; keep it at HIGH
        return jnp.einsum("bst,bcts->bcs", w_row, p,
                          precision=jax.lax.Precision.HIGH)

    value_contract = contract_split if weight_split else (
        lambda tl: contract(tl, precision))
    if grad_precision is None or C == 1:
        return value_contract(tiles) if weight_split else \
            contract(tiles, precision)
    return jnp.concatenate(
        [value_contract(tiles[:, :1]),
         contract(tiles[:, 1:], grad_precision)], axis=1)


def sample_maps_tiled(imgs: jnp.ndarray, cx, cy, xs, ys, tile: int):
    """Convenience: tiles around (cx, cy) then sample (B, S) coords from
    each of the (C, H, W) maps. Returns (B, C, S)."""
    H, W = imgs.shape[-2:]
    ox, oy = tile_origins(cx, cy, tile, H, W)
    tiles = gather_tiles(imgs, ox, oy, tile)
    return bilinear_sample_tiles(tiles, ox, oy, xs, ys)


class TileAtlas:
    """Fixed-grid overlapping tile atlas (see build_atlas)."""

    def __init__(self, flat, n_by, n_bx, C, tile, stride):
        self.flat = flat          # (n_by * n_bx, C * tile * tile)
        self.n_by = n_by
        self.n_bx = n_bx
        self.C = C
        self.tile = tile
        self.stride = stride


def build_atlas(maps: jnp.ndarray, tile: int, stride: int) -> TileAtlas:
    """Precompute overlapping TxT tiles at a fixed stride grid.

    Fetching from a precomputed atlas is one contiguous row gather per
    candidate instead of a per-candidate dynamic_slice. The atlas
    guarantees every window of half-width w <= tile/2 - stride/2 - 1
    around any point is covered by its nearest tile.

    maps: (C, H, W). tile must be a multiple of stride.
    """
    assert tile % stride == 0
    C, H, W = maps.shape
    k = tile // stride
    n_by = -(-H // stride)
    n_bx = -(-W // stride)
    pad_h = (n_by + k - 1) * stride - H
    pad_w = (n_bx + k - 1) * stride - W
    # edge-replicate padding keeps beyond-border samples equal to the
    # reference's clamped bilinear sampling (utility.h:159-172)
    padded = jnp.pad(maps, ((0, 0), (0, pad_h), (0, pad_w)), mode="edge")
    blocks = padded.reshape(C, n_by + k - 1, stride, n_bx + k - 1, stride)
    blocks = jnp.transpose(blocks, (1, 3, 0, 2, 4))   # (BY, BX, C, s, s)
    rows = []
    for a in range(k):
        row = jnp.concatenate(
            [blocks[a:a + n_by, b:b + n_bx] for b in range(k)], axis=-1)
        rows.append(row)
    atlas = jnp.concatenate(rows, axis=-2)            # (n_by, n_bx, C, T, T)
    flat = atlas.reshape(n_by * n_bx, C * tile * tile)
    return TileAtlas(flat, n_by, n_bx, C, tile, stride)


def fetch_atlas_tiles(atlas: TileAtlas, cx, cy):
    """Per-candidate tiles from the atlas: (B, C, T, T) + origins (ox, oy).
    Picks the tile whose origin is nearest to (c - tile/2)."""
    T = atlas.tile
    s = atlas.stride
    ty = jnp.clip(jnp.round((cy - T / 2.0) / s).astype(jnp.int32),
                  0, atlas.n_by - 1)
    tx = jnp.clip(jnp.round((cx - T / 2.0) / s).astype(jnp.int32),
                  0, atlas.n_bx - 1)
    tid = ty * atlas.n_bx + tx
    tiles = atlas.flat[tid].reshape(-1, atlas.C, T, T)
    return tiles, tx * s, ty * s


def sample_atlas(atlas: TileAtlas, cx, cy, xs, ys):
    """Atlas-backed equivalent of sample_maps_tiled: (B, C, S)."""
    tiles, ox, oy = fetch_atlas_tiles(atlas, cx, cy)
    return bilinear_sample_tiles(tiles, ox, oy, xs, ys)


def map_chunked(fn, args, batch: int, chunk: int, active=None):
    """Apply `fn` (pytree of (chunk, ...) arrays -> pytree of (chunk, ...)
    arrays) over a (batch, ...) pytree in sequential chunks via lax.map -
    bounds the device-memory working set of tile buffers and einsum
    temporaries.

    `active`: optional (batch,) bool mask. Chunks whose mask is all-False
    are skipped with a lax.cond (their outputs are zeros) - with actives
    packed first (the flat-compaction layout used throughout the cascade)
    this makes the padded tail of a static capacity budget nearly free:
    no tile fetch, no sampling einsums, no GN iterations. Callers must
    consume outputs only on active lanes.
    """
    n_chunks = -(-batch // chunk)
    pad = n_chunks * chunk - batch

    def pad_reshape(a):
        a = jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        return a.reshape(n_chunks, chunk, *a.shape[1:])

    args_c = jax.tree_util.tree_map(pad_reshape, args)
    if active is None:
        out = jax.lax.map(fn, args_c)
    else:
        act_c = pad_reshape(active)
        out_shapes = jax.eval_shape(
            fn, jax.tree_util.tree_map(lambda a: a[0], args_c))

        def guarded(carry):
            args_i, act_i = carry
            return jax.lax.cond(
                jnp.any(act_i),
                lambda: fn(args_i),
                lambda: jax.tree_util.tree_map(
                    lambda s: jnp.zeros(s.shape, s.dtype), out_shapes))

        out = jax.lax.map(guarded, (args_c, act_c))
    return jax.tree_util.tree_map(
        lambda a: a.reshape(n_chunks * chunk, *a.shape[2:])[:batch], out)
