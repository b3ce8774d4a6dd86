#!/usr/bin/env python
"""Microbenchmark: ops/sortfree.py vs the XLA sort/top_k/cumsum ops they
replace, at the production shapes of the cascade. Run on an
otherwise-idle GPU:  python benchmarks/sortfree_micro.py
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from edge_based_visual_odometry_tpu.ops import sortfree as SF


def timeit(fn, *args, n=20):
    out = jax.block_until_ready(fn(*args))          # compile
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3     # ms


def main():
    g = np.random.default_rng(0)
    rows = []

    # grid-build argsort: 32768 int32 keys
    keys = jnp.asarray(g.integers(0, 900000, 32768).astype(np.int32))
    rows.append(("argsort 32k keys",
                 timeit(jax.jit(lambda k: jnp.argsort(k, stable=True)), keys),
                 timeit(jax.jit(SF.argsort_flat_stable), keys)))

    # stereo gather compaction: top_k (32768, 160) -> 32
    sc = jnp.asarray(g.normal(size=(32768, 160)).astype(np.float32))
    rows.append(("top_k (32768,160)->32",
                 timeit(jax.jit(lambda s: jax.lax.top_k(s, 32)[1]), sc),
                 timeit(jax.jit(lambda s: SF.top_k_order_rows(s, 32)), sc)))

    # temporal gather compaction: top_k (24576, 195) -> 32
    sc2 = jnp.asarray(g.normal(size=(24576, 195)).astype(np.float32))
    rows.append(("top_k (24576,195)->32",
                 timeit(jax.jit(lambda s: jax.lax.top_k(s, 32)[1]), sc2),
                 timeit(jax.jit(lambda s: SF.top_k_order_rows(s, 32)), sc2)))

    # BNB double argsort (32768, 32)
    k2 = jnp.asarray(g.normal(size=(32768, 32)).astype(np.float32))

    def bnb_old(k):
        o = jnp.argsort(k, axis=-1, stable=True)
        return o, jnp.argsort(o, axis=-1)

    rows.append(("bnb argsort x2 (32768,32)",
                 timeit(jax.jit(bnb_old), k2),
                 timeit(jax.jit(SF.argsort_rows_asc), k2)))

    # flatten_active cumsum (1M flags)
    fl = jnp.asarray(g.integers(0, 2, 1048576).astype(bool))
    rows.append(("cumsum 1M flags",
                 timeit(jax.jit(lambda f: jnp.cumsum(f.astype(jnp.int32))), fl),
                 timeit(jax.jit(SF.cumsum_i32), fl)))

    # TOED extract cumsum (2x 1.87M, vmapped)
    fl2 = jnp.asarray(g.integers(0, 2, (2, 752 * 2482)).astype(bool))
    rows.append(("cumsum 2x1.87M (vmap)",
                 timeit(jax.jit(jax.vmap(
                     lambda f: jnp.cumsum(f.astype(jnp.int32)))), fl2),
                 timeit(jax.jit(jax.vmap(SF.cumsum_i32)), fl2)))

    # PROSAC lift: counting sort 786432 entries, 34 classes -> 32768
    cls = jnp.asarray(g.integers(0, 32, 786432).astype(np.int32))
    mask = jnp.asarray(g.random(786432) < 0.06)

    def lift_old(c, m):
        n = c.shape[0]
        key = jnp.where(m, c * n + jnp.arange(n, dtype=jnp.int32),
                        jnp.int32(2**31 - 1))
        return jax.lax.top_k(-key, 32768)[1]

    rows.append(("lift top_k 786k->32k",
                 timeit(jax.jit(lift_old), cls, mask),
                 timeit(jax.jit(lambda c, m: SF.counting_sort_order(
                     c, m, 34, 32768)[0]), cls, mask)))

    # GN two-phase partition (131072 flags)
    fl3 = jnp.asarray(g.integers(0, 2, 131072).astype(bool))
    rows.append(("partition 131072",
                 timeit(jax.jit(lambda f: jnp.argsort(
                     f.astype(jnp.int32), stable=True)), fl3),
                 timeit(jax.jit(SF.partition_order_stable), fl3)))

    print(f"{'case':28s} {'xla ms':>8s} {'sortfree ms':>12s} {'speedup':>8s}")
    for name, old, new in rows:
        print(f"{name:28s} {old:8.2f} {new:12.2f} {old / new:8.1f}x")


if __name__ == "__main__":
    main()
