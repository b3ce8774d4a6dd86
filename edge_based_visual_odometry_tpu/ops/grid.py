"""Scatter-free spatial indexing: sort-by-band + searchsorted range queries.

A fixed-shape replacement for the reference's SpatialGrid
(include/Dataset.h:22-114), whose build is a two-phase parallel-classify /
serial-insert into std::vector cells and whose query concatenates
variable-length cell lists. Here:

  build: edges are sorted once by a composite (y-band, x) key - a pure
         argsort, no scatter conflicts.
  query: a (qx, qy, rx, ry) box query becomes `n_bands` contiguous segments
         of the sorted order, located with searchsorted and gathered into
         fixed-size slot windows with validity masks.

Unlike the reference's cell-granular query (which returns everything in the
ceil(r/cell)-neighborhood, i.e. a superset of the radius - Dataset.h:69-113),
this returns exactly the edges whose x lies in [qx-rx, qx+rx] and whose
y-band overlaps [qy-ry, qy+ry]; downstream exact filters are unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import sortfree as SF


class SortedGrid(NamedTuple):
    """Final sorted structure with int32 composite keys."""
    sorted_idx: jnp.ndarray    # (N,)
    sorted_keys: jnp.ndarray   # (N,) int32 composite (band, x/16px)
    sorted_attrs: jnp.ndarray  # (A, N) edge attributes in sorted order,
                               # ATTRIBUTE-MAJOR: a query's attr fetch is
                               # one gather per attribute with the (large)
                               # slot axis minor. An (N, A) row-gather
                               # would produce (Q, S, A) outputs with a
                               # tiny minor axis, which tiled layouts pad
                               # many times over
    start: jnp.ndarray         # (n_bands * W * 16 + 1,) int32 bucket
                               # start table: start[k] = #sorted keys < k.
                               # Replaces searchsorted range location with
                               # an O(1) lookup (no log(N) rounds of
                               # serial gathers)
    band_h: float
    n_bands: int
    width: int


def build_sorted_grid(x, y, valid, width: int, height: int,
                      band_h: int, attrs=None) -> SortedGrid:
    """Build the sorted composite-key index (see module docstring).

    Composite int32 key = band * (W*16) + round(x*16): x quantized to
    1/16 px so the key stays monotone in (band, x) and fits int32 for any
    realistic image size.

    attrs: optional (N, A) per-edge payload; stored attribute-major in
    sorted order so a query's attribute fetch is one contiguous
    gather per attribute (see SortedGrid.sorted_attrs).
    """
    n_bands = -(-height // band_h)
    W16 = jnp.int32(width * 16)
    band = jnp.clip(jnp.floor(y / band_h), 0, n_bands - 1).astype(jnp.int32)
    xq = jnp.clip(jnp.round(x * 16.0), 0, width * 16 - 1).astype(jnp.int32)
    key = band * W16 + xq
    key = jnp.where(valid, key, jnp.int32((n_bands + 1) * width * 16))
    # comparison-count rank instead of XLA's argsort (ops/sortfree.py)
    order = SF.argsort_flat_stable(key)
    if attrs is None:
        attrs = jnp.stack([x, y], -1)
    # the original-index plane rides WITH the attributes (f32 is exact
    # for indices < 2^24): one more plane in the fused attr gather
    # instead of a separate sorted_idx[pos] gather
    attrs = jnp.concatenate(
        [jnp.arange(x.shape[0], dtype=jnp.float32)[:, None], attrs], -1)
    # bucket start table: histogram over the key domain + prefix sum.
    # start[k] = #valid keys < k, i.e. searchsorted(sorted_keys, k, 'left')
    # for every k in [0, n_bands * W16] - queries become O(1) lookups.
    nb = n_bands * width * 16
    hist = jnp.zeros((nb + 1,), jnp.int32).at[
        jnp.minimum(key, nb)].add(valid.astype(jnp.int32), mode="drop")
    start = SF.cumsum_i32(hist) - hist               # exclusive
    return SortedGrid(order, key[order], attrs.T[:, order], start,
                      float(band_h), int(n_bands), int(width))


def _band_window_positions(grid: SortedGrid, qx, qy, rx: float, ry: float,
                           slots_per_band: int, n_band_window: int):
    """Shared body of the box queries: searchsorted band spans ->
    (pos, mask) of shape (Q, n_band_window * slots_per_band) into the
    sorted arrays.

    Spans are located with the precomputed bucket start table (O(1) per
    query) rather than searchsorted's log(N) serial gather rounds."""
    W16 = jnp.int32(grid.width * 16)
    nb = jnp.int32(grid.n_bands) * W16
    b0 = jnp.floor((qy - ry) / grid.band_h).astype(jnp.int32)
    xq_lo = jnp.clip(jnp.floor((qx - rx) * 16.0), 0,
                     grid.width * 16 - 1).astype(jnp.int32)
    xq_hi = jnp.clip(jnp.ceil((qx + rx) * 16.0), 0,
                     grid.width * 16 - 1).astype(jnp.int32)
    N = grid.sorted_idx.shape[0]
    ks = jnp.arange(n_band_window, dtype=jnp.int32)
    b = b0[None, :] + ks[:, None]                       # (K, Q)
    b_ok = (b >= 0) & (b < grid.n_bands)
    # out-of-range bands are masked by b_ok; clamp their table indices
    k_lo = jnp.clip(b * W16 + xq_lo[None, :], 0, nb)
    k_hi = jnp.clip(b * W16 + xq_hi[None, :] + 1, 0, nb)
    lo = grid.start[k_lo]       # searchsorted(keys, k, side='left')
    hi = grid.start[k_hi]       # searchsorted(keys, k, side='right')
    offs = jnp.arange(slots_per_band, dtype=jnp.int32)
    pos = lo[:, :, None] + offs[None, None, :]          # (K, Q, S)
    m = (pos < hi[:, :, None]) & b_ok[:, :, None] & (pos < N)
    pos = jnp.minimum(pos, N - 1)
    # (K, Q, S) -> (Q, K*S), matching the previous per-band concat order
    pos = jnp.transpose(pos, (1, 0, 2)).reshape(qx.shape[0], -1)
    m = jnp.transpose(m, (1, 0, 2)).reshape(qx.shape[0], -1)
    return pos, m


def query_sorted_grid(grid: SortedGrid, qx, qy, rx: float, ry: float,
                      slots_per_band: int, n_band_window: int):
    """Box query; qx, qy: (Q,). Returns (idx, mask) of shape
    (Q, n_band_window * slots_per_band); idx indexes the ORIGINAL edge
    arrays; mask=False entries have idx 0."""
    pos, mask = _band_window_positions(grid, qx, qy, rx, ry,
                                       slots_per_band, n_band_window)
    return jnp.where(mask, grid.sorted_idx[pos], 0), mask


def query_sorted_grid_attrs(grid: SortedGrid, qx, qy, rx: float, ry: float,
                            slots_per_band: int, n_band_window: int):
    """Box query returning (idx, attrs, mask): attrs is ATTRIBUTE-MAJOR
    (A, Q, S) - index attrs[k] for the k-th attribute's (Q, S) plane.
    The slot axis stays minor so any layout padding applies to S
    (large), not A (tiny). idx comes out of the same fused gather (plane 0 of the
    stored payload; see build_sorted_grid).

    GUARANTEE: every masked-True slot refers to a VALID source entry -
    invalid entries carry the sentinel key, sort past every in-range
    band span, and pos < hi excludes them. Callers must NOT re-gather a
    validity flag (a redundant pred gather over the whole window)."""
    pos, mask = _band_window_positions(grid, qx, qy, rx, ry,
                                       slots_per_band, n_band_window)
    g = grid.sorted_attrs[:, pos]
    idx = jnp.where(mask, g[0].astype(jnp.int32), 0)
    return idx, g[1:], mask


def _compact_score(mask, priority):
    """Slot-ranking score shared by the compaction variants: valid
    entries first (original order, or ascending `priority`)."""
    S = mask.shape[-1]
    slot_iota = jax.lax.broadcasted_iota(jnp.int32, mask.shape, mask.ndim - 1)
    if priority is None:
        return jnp.where(mask, -slot_iota.astype(jnp.float32),
                         -jnp.float32(2 * S))
    return jnp.where(mask, -priority, -jnp.float32(3.0e38))


# beyond this row width the O(S^2) comparison rank loses to XLA's sort;
# only the once-per-sequence bootstrap temporal window (S=576) exceeds it
_MAX_RANK_WIDTH = 384


def _compact_planes(mask, capacity, priority, planes):
    """Compact (A, Q, S) f32 planes to (A, Q, capacity), valid slots
    first (by `priority` when given). Two regimes:

      S <= _MAX_RANK_WIDTH: comparison-count rank + ONE one-hot
        dot_general (sortfree.compact_by_rank) - no per-row
        take_along gathers at all. Dead output slots are 0.0.
      wider: XLA top_k + take_along_axis.

    Returns (A, Q, capacity) f32; callers re-cast idx/mask planes.
    """
    S = mask.shape[-1]
    score = _compact_score(mask, priority)
    if SF.ENABLED and S <= _MAX_RANK_WIDTH:
        rank = SF.rank_desc_rows(score)
        return SF.compact_by_rank(rank, capacity, planes)
    _, order = jax.lax.top_k(score, capacity)
    return jnp.take_along_axis(planes, order[None], axis=-1)


def compact_candidates(idx, mask, capacity: int, priority=None):
    """Compact (Q, S) masked slots to (Q, capacity).

    Valid entries move to the front preserving order (or by ascending
    `priority` when given). Overflow beyond capacity is dropped.
    NOTE: dead output slots (rank >= #valid) carry idx 0 / value 0.0 with
    mask False - consume only masked slots.
    """
    planes = jnp.stack([idx.astype(jnp.float32),
                        mask.astype(jnp.float32)])
    out = _compact_planes(mask, capacity, priority, planes)
    return out[0].astype(jnp.int32), out[1] > 0.5


def compact_candidates_attrs(idx, attrs, mask, capacity: int, priority=None):
    """compact_candidates + carry the attribute-major (A, Q, S) attribute
    planes along (-> (A, Q, capacity))."""
    planes = jnp.concatenate([
        jnp.stack([idx.astype(jnp.float32), mask.astype(jnp.float32)]),
        attrs], axis=0)
    out = _compact_planes(mask, capacity, priority, planes)
    return out[0].astype(jnp.int32), out[2:], out[1] > 0.5
