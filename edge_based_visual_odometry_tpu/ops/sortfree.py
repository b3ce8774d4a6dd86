"""Sort-free exact replacements for XLA sort / top_k / cumsum hot spots.

On the accelerator this code was first tuned for, XLA sorts and
flat-array scans were about half of the production frame: the grid
builds' argsort, the gather-window top_k compactions over (32768, 160) /
(24576, 195) score tensors, the BNB double argsort, the PROSAC lift's
top_k over 786k keys, and the cumsum+scatter compaction machinery. XLA
lowered them to sort networks and sequential scans.

Every routine here computes the IDENTICAL permutation/prefix-sum with
matmul- and elementwise-friendly primitives instead:

  - `cumsum_i32`      - blocked triangular-matmul prefix sum (exact for
                        integer values < 2^24; matmul accumulates in f32).
  - `rank_desc_rows`  - per-row dense rank by comparison counting
                        (rank[i] = #{j : (s_j, j) sorts before (s_i, i)});
                        O(S^2) elementwise work per row, which for the
                        cascade's S <= 256 slot axes is far cheaper than a
                        bitonic sort of the same rows.
  - `order_from_rank` - scatter a rank permutation into its order array.
  - `counting_sort_order` - stable counting sort over a SMALL class
                        domain (the PROSAC lift's candidate-count key),
                        via one-hot blocked cumsums.
  - `partition_order_stable` - stable two-way partition (argsort of a
                        boolean flag) via two prefix sums.

Exactness contract: each function documents the jnp reference expression
it must match bit-for-bit (tie handling included); tests/test_sortfree.py
asserts equality on adversarial inputs. `ENABLED = False` reverts every
caller to the original XLA-sort formulations; which side is faster on a
GPU (where XLA sorts with its own GPU sort) is not measured yet.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Bisect switch: False restores the XLA sort/top_k/cumsum formulations in
# every caller (checked at TRACE time - flip + re-jit; see module docstring).
ENABLED = True

# f32 matmul with HIGHEST precision is exact for integer-valued operands
# whose products and partial sums stay below 2^24 (the 6-pass bf16
# decomposition reconstructs full f32; accumulation is f32).
_EXACT = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _lower_tri_np(n: int, strict: bool, dtype_name: str = "float32"):
    a = np.tri(n, k=-1 if strict else 0, dtype=dtype_name).T
    a.setflags(write=False)
    return a


def _lower_tri(n: int, strict: bool):
    """(n, n) upper-triangular-of-ones accumulator: LT[i, j] = 1 if
    (i < j) or (i <= j when not strict) - column j accumulates rows i.
    The numpy array is cached; the jnp constant is created per trace
    (caching a traced constant leaks tracers across jit contexts)."""
    return jnp.asarray(_lower_tri_np(n, strict))


def _cumsum_cols(x2d: jnp.ndarray, block: int) -> jnp.ndarray:
    """Inclusive cumsum along axis -1 of (..., block) f32 via one
    triangular matmul (exact for integer values, see _EXACT)."""
    return jnp.matmul(x2d, _lower_tri(block, strict=False),
                      precision=_EXACT)


def cumsum_i32(x: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """Inclusive prefix sum of a 1-D int32/bool array; exact match for
    jnp.cumsum(x.astype(int32)) for totals < 2^24.

    Blocked two-level structure: in-block prefix sums are one (R, block)
    @ (block, block) triangular matmul; block offsets recurse.
    """
    n = x.shape[0]
    total_bound_ok = n < (1 << 24)
    assert total_bound_ok, "cumsum_i32 exactness bound exceeded"
    if not ENABLED:
        return jnp.cumsum(x.astype(jnp.int32))
    if n <= block:
        xf = x.astype(jnp.float32)[None, :]
        pad = block - n
        xf = jnp.pad(xf, ((0, 0), (0, pad)))
        return _cumsum_cols(xf, block)[0, :n].astype(jnp.int32)
    R = -(-n // block)
    pad = R * block - n
    xf = jnp.pad(x.astype(jnp.float32), (0, pad)).reshape(R, block)
    inner = _cumsum_cols(xf, block)                  # (R, block) inclusive
    tot = inner[:, -1]                               # (R,)
    # exclusive offsets of the block totals (recursion on a 1/block-size
    # problem; at most ~3 levels for the pipeline's <= 5M-element arrays)
    off = cumsum_i32(tot.astype(jnp.int32), block) - tot.astype(jnp.int32)
    out = inner + off.astype(jnp.float32)[:, None]
    return out.reshape(-1)[:n].astype(jnp.int32)


def _row_chunked(fn, args, n_rows: int, chunk: int):
    """lax.map `fn` over row chunks of equally-shaped (N, ...) arrays."""
    n_chunks = -(-n_rows // chunk)
    pad = n_chunks * chunk - n_rows

    def pr(a):
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)).reshape(
            n_chunks, chunk, *a.shape[1:])

    out = jax.lax.map(fn, jax.tree_util.tree_map(pr, args))
    return jax.tree_util.tree_map(
        lambda a: a.reshape(n_chunks * chunk, *a.shape[2:])[:n_rows], out)


def rank_desc_rows(score: jnp.ndarray, chunk: int = 2048) -> jnp.ndarray:
    """Stable descending rank along the last axis of (N, S) f32 scores:

        rank[n, i] = #{ j : score[n, j] > score[n, i]
                            or (score[n, j] == score[n, i] and j < i) }

    i.e. jnp.argsort(jnp.argsort(-score, stable=True), stable=True) and
    exactly the slot permutation jax.lax.top_k(score, S) produces (ties
    broken toward the lower index). O(S^2) comparison counting per row,
    evaluated in row chunks to bound the (chunk, S, S) temporaries.

    Assumes finite scores. -0.0 is canonicalized to +0.0 (ties broken by
    index), where XLA's sort total order would put -0.0 strictly first -
    a boundary case no pipeline score path produces meaningfully.
    """
    S = score.shape[-1]
    iota = jnp.arange(S, dtype=jnp.int32)
    score = jnp.where(score == 0.0, jnp.zeros_like(score), score)
    # keep the per-chunk (rows, S, S) comparison temp under ~64 MiB
    chunk = max(8, min(chunk, (1 << 26) // max(S * S, 1)))

    def one_chunk(sc):
        s_i = sc[:, :, None]       # (c, S, 1) the element being ranked
        s_j = sc[:, None, :]       # (c, 1, S) everyone it is compared to
        before = (s_j > s_i) | ((s_j == s_i)
                                & (iota[None, :] < iota[:, None])[None])
        return jnp.sum(before, axis=-1, dtype=jnp.int32)

    if score.shape[0] <= chunk:
        return one_chunk(score)
    return _row_chunked(one_chunk, score, score.shape[0], chunk)


def order_from_rank(rank: jnp.ndarray, capacity: int) -> jnp.ndarray:
    """Invert a per-row rank permutation into the order array top_k
    returns: order[n, r] = i such that rank[n, i] == r, for r < capacity.

    rank rows must be permutations of 0..S-1 (rank_desc_rows output).
    Entries with rank >= capacity are dropped (distinct out-of-bounds
    targets - the repo-wide unique_indices scatter rule, see
    ops/toed.extract_edges).
    """
    N, S = rank.shape
    iota_s = jax.lax.broadcasted_iota(jnp.int32, (N, S), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (N, S), 0)
    flat_tgt = jnp.where(rank < capacity, row * capacity + rank,
                         N * capacity + row * S + iota_s)
    out = jnp.zeros((N * capacity,), jnp.int32).at[
        flat_tgt.reshape(-1)].set(iota_s.reshape(-1), mode="drop",
                                  unique_indices=True)
    return out.reshape(N, capacity)


def top_k_order_rows(score: jnp.ndarray, capacity: int,
                     chunk: int = 2048,
                     max_rank_width: int = 384) -> jnp.ndarray:
    """Drop-in replacement for `_, order = jax.lax.top_k(score, capacity)`
    on (N, S) f32 scores (identical order, including tie handling).

    Rows wider than `max_rank_width` fall back to XLA top_k: the O(S^2)
    comparison count loses to the sort there (only the once-per-sequence
    bootstrap temporal program's S=576 window exceeds it)."""
    if not ENABLED or score.shape[-1] > max_rank_width:
        _, order = jax.lax.top_k(score, capacity)
        return order
    rank = rank_desc_rows(score, chunk=chunk)
    return order_from_rank(rank, capacity)


def compact_by_rank(rank: jnp.ndarray, capacity: int, planes: jnp.ndarray,
                    chunk: int = 4096) -> jnp.ndarray:
    """Gather-free compaction: out[a, n, r] = planes[a, n, s] where
    rank[n, s] == r (0.0 where no slot has rank r), for r < capacity.

    planes: (A, N, S) float32 value planes sharing one rank permutation.
    Equivalent to stacking take_along_axis(plane, order) with
    order = order_from_rank(rank, capacity) - but as ONE one-hot
    dot_general instead of A per-row gathers at (32768, 160).
    Exact: the one-hot operand is 0/1 (exactly representable at any
    precision) and each output is a sum with exactly one nonzero term;
    HIGHEST precision keeps the f32 value operand exact.
    """
    A, N, S = planes.shape

    def one_chunk(args):
        rk, pl = args                   # (c, S), (c, A, S)
        oh = (rk[:, :, None]
              == jnp.arange(capacity, dtype=rk.dtype)[None, None, :])
        return jnp.einsum("nas,nsr->nar", pl, oh.astype(jnp.float32),
                          precision=_EXACT)

    planes_nm = jnp.moveaxis(planes, 0, 1)          # (N, A, S)
    if N <= chunk:
        out = one_chunk((rank, planes_nm))
    else:
        out = _row_chunked(one_chunk, (rank, planes_nm), N, chunk)
    return jnp.moveaxis(out, 1, 0)                  # (A, N, capacity)


def expand_by_rank(rank: jnp.ndarray, row_vals: jnp.ndarray) -> jnp.ndarray:
    """Inverse of compact_by_rank for full-width permutations:
    out[n, s] = row_vals[n, rank[n, s]] (take_along_axis by rank) as a
    one-hot dot_general. row_vals: (N, R) f32; rank values must be < R."""
    N, R = row_vals.shape
    oh = (rank[:, :, None]
          == jnp.arange(R, dtype=rank.dtype)[None, None, :])
    return jnp.einsum("nr,nsr->ns", row_vals, oh.astype(jnp.float32),
                      precision=_EXACT)


def argsort_rows_asc(key: jnp.ndarray, chunk: int = 2048):
    """(rank, order) for stable ascending per-row argsort of (N, S) keys:
    order == jnp.argsort(key, axis=-1, stable=True) and rank == its
    inverse permutation (jnp.argsort(order)). One comparison-count pass
    yields both (the double argsort costs two sorts in XLA)."""
    if not ENABLED:
        order = jnp.argsort(key, axis=-1, stable=True)
        return jnp.argsort(order, axis=-1), order
    rank = rank_desc_rows(-key, chunk=chunk)
    return rank, order_from_rank(rank, key.shape[-1])


def argsort_flat_stable(keys: jnp.ndarray, chunk: int = 8192) -> jnp.ndarray:
    """Stable ascending argsort of a 1-D int32 key array by global
    comparison counting: exact match for jnp.argsort(keys, stable=True).

    O(n^2) comparisons evaluated as (n, chunk) blocks - for the grid
    builds' n ~ 32k this is ~1G elementwise compare+adds.
    """
    if not ENABLED:
        return jnp.argsort(keys, stable=True).astype(jnp.int32)
    n = keys.shape[0]
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    # padded keys get INT32_MAX and index >= n: they rank AFTER every
    # real element (ties with a real INT32_MAX key break by index), so
    # real ranks are unaffected
    kp = jnp.pad(keys, (0, pad), constant_values=np.int32(2**31 - 1))
    idx = jnp.arange(n_chunks * chunk, dtype=jnp.int32)
    kc = kp.reshape(n_chunks, chunk)
    ic = idx.reshape(n_chunks, chunk)

    def body(c, rank):
        kj = kc[c][None, :]                       # (1, chunk)
        ij = ic[c][None, :]
        before = (kj < kp[:, None]) | ((kj == kp[:, None])
                                       & (ij < idx[:, None]))
        return rank + jnp.sum(before, axis=-1, dtype=jnp.int32)

    rank = jax.lax.fori_loop(0, n_chunks, body,
                             jnp.zeros((n_chunks * chunk,), jnp.int32))
    order = jnp.zeros((n_chunks * chunk,), jnp.int32).at[rank].set(
        idx, mode="drop", unique_indices=True)
    return order[:n]


def partition_order_stable(flag: jnp.ndarray) -> jnp.ndarray:
    """Stable argsort of a 1-D boolean/0-1 flag (False first): exact match
    for jnp.argsort(flag.astype(int32), stable=True). Two prefix sums."""
    if not ENABLED:
        return jnp.argsort(flag.astype(jnp.int32), stable=True).astype(
            jnp.int32)
    n = flag.shape[0]
    f = flag.astype(jnp.int32)
    cs_true = cumsum_i32(f)
    n_false = n - cs_true[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    cs_false = (idx + 1) - cs_true
    rank = jnp.where(flag, n_false + cs_true - 1, cs_false - 1)
    return jnp.zeros((n,), jnp.int32).at[rank].set(
        idx, unique_indices=True)


def counting_sort_order(class_idx: jnp.ndarray, mask: jnp.ndarray,
                        n_classes: int, n_out: int,
                        block: int = 256):
    """First n_out entries of the stable ascending argsort of

        key = where(mask, class_idx * n + arange(n), +inf)

    i.e. masked entries sorted by (class, original position) - the PROSAC
    lift ordering (models/motion_tracker.lift_quads). Returns
    (order, n_valid): order matches jax.lax.top_k(-key, n_out)[1] on its
    first min(n_valid, n_out) slots; slots past n_valid point at index 0,
    so callers MUST mask by n_valid (the top_k tail instead pointed at
    masked entries, which lift_quads masked through flat(mask)).

    Counting sort: per-class blocked prefix sums over a one-hot
    (n, n_classes) expansion - O(n * n_classes) MXU work instead of a
    bitonic sort of n ~ 786k keys.
    """
    n = class_idx.shape[0]
    if not ENABLED:
        big = jnp.int32(2**31 - 1)
        key = jnp.where(mask, class_idx * n + jnp.arange(n, dtype=jnp.int32),
                        big)
        _, order = jax.lax.top_k(-key, n_out)
        return order, jnp.sum(mask).astype(jnp.int32)
    assert n < (1 << 24)
    R = -(-n // block)
    pad = R * block - n
    cls = jnp.where(mask, class_idx, n_classes)      # pad class = dropped
    cls = jnp.pad(cls, (0, pad), constant_values=n_classes)
    oh = (cls[:, None] == jnp.arange(n_classes, dtype=cls.dtype)[None, :])
    ohf = oh.astype(jnp.float32).reshape(R, block, n_classes)
    # within-block inclusive prefix per class: (R, block, C) x (block, block)
    inner = jnp.einsum("rbc,bd->rdc", ohf,
                       _lower_tri(block, strict=False), precision=_EXACT)
    tot = inner[:, -1, :]                            # (R, C) block totals
    # exclusive block offsets per class via a triangular einsum along R
    # (values < 2^24 stay exact; jnp.cumsum would lower to a slow
    # reduce-window on this axis)
    assert R <= 8192, "counting_sort_order block-offset matrix too large"
    ii = jax.lax.broadcasted_iota(jnp.int32, (R, R), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (R, R), 1)
    lt_r = (ii < jj).astype(jnp.float32)             # strict: exclusive
    off = jnp.einsum("rc,rs->sc", tot, lt_r, precision=_EXACT)
    within = inner + off[:, None, :]                 # inclusive class rank
    hist = tot.sum(0)                                # (C,) class totals
    class_off = jnp.cumsum(hist) - hist              # exclusive class base
    # each element's own class rank: reuse the one-hot instead of a
    # take_along gather of 786k single elements; exactly one nonzero
    # term per row
    cls_i = jnp.minimum(cls, n_classes - 1).astype(jnp.int32)
    wr = jnp.sum(within.reshape(R * block, n_classes)
                 * oh.astype(jnp.float32), axis=1) - 1.0
    base = class_off[cls_i]
    pos = (base + wr).astype(jnp.int32)
    keep = cls < n_classes
    idx = jnp.arange(R * block, dtype=jnp.int32)
    tgt = jnp.where(keep & (pos < n_out), pos, n_out + idx)
    order = jnp.zeros((n_out,), jnp.int32).at[tgt].set(
        idx, mode="drop", unique_indices=True)
    n_valid = hist.sum().astype(jnp.int32)
    return order, n_valid
