"""Vectorized agglomerative edge clustering.

A fixed-shape replacement for the reference's EdgeClusterer
(src/EdgeClusterer.cpp:119-302): the reference runs a greedy
repeat-until-fixed-point nearest-neighbor merge under
(dist < CLUSTER_DIST_THRESH [, orient diff < CLUSTER_ORIENT_THRESH])
with a max-cluster-size cap, then replaces every cluster by its
Gaussian-distance-weighted average edge.

Here clustering is connected components of the thresholded pairwise
distance graph, computed by iterative min-label propagation over a (C, C)
adjacency matrix, vmapped over rows of the (N, C) candidate tensor.

DELIBERATE DEVIATION (documented per SURVEY.md §7 hard-part #4): without
the size cap, greedy merge-to-fixpoint is exactly connected components.
The reference's MAX_CLUSTER_SIZE=10 cap refuses merges in greedy
nearest-first order (inherently sequential); the vectorized equivalent
(`max_cluster_size` arg) keeps the cap members nearest the component
centroid and reverts the rest to singleton hypotheses. The
Gaussian-weighted representative (EdgeClusterer.cpp:43-117) is
reproduced numerically.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ClusterResult(NamedTuple):
    x: jnp.ndarray        # (..., C) cluster-center x (representative slots)
    y: jnp.ndarray        # (..., C)
    theta: jnp.ndarray    # (..., C)
    mask: jnp.ndarray     # (..., C) True only at representative slots
    label: jnp.ndarray    # (..., C) int32 component label (min member slot)
    members: jnp.ndarray  # (..., C, C) bool membership matrix M[r, j]


def cluster_edges(x, y, theta, mask,
                  dist_thresh: float = 1.0,
                  orient_thresh_deg: float = 20.0,
                  by_orientation: bool = True,
                  gauss_sigma: float = 2.0,
                  max_cluster_size: int = 0) -> ClusterResult:
    """Cluster the last-axis candidate sets of (..., C) edge arrays.

    Orientation gate mirrors EdgeClusterer.cpp:156: raw radian difference
    |t_i - t_j| < deg2rad(thresh), no wrap (as in the reference).

    `max_cluster_size` > 0 enforces the reference's MAX_CLUSTER_SIZE cap
    (EdgeClusterer.cpp:179: a merge that would exceed the cap is refused,
    leaving separate hypotheses). The greedy merge order is inherently
    sequential; the vectorized equivalent keeps the `cap` members nearest
    the component centroid (the reference's nearest-first merge accretes
    around the dense core) and reverts the rest to singleton clusters.
    0 disables the cap (pure connected components).
    """
    C = x.shape[-1]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    dist = jnp.sqrt(dx * dx + dy * dy)
    adj = dist < dist_thresh
    if by_orientation:
        dth = jnp.abs(theta[..., :, None] - theta[..., None, :])
        adj = adj & (dth < jnp.deg2rad(orient_thresh_deg))
    pair_ok = mask[..., :, None] & mask[..., None, :]
    eye = jnp.eye(C, dtype=bool)
    adj = (adj & pair_ok) | eye  # self-loops keep isolated edges stable

    labels = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)

    def body(_, lab):
        # propagate min label across graph edges (reach distance d -> d+1)
        lab_j = jnp.broadcast_to(lab[..., None, :], adj.shape)
        masked = jnp.where(adj, lab_j, C)
        lab = jnp.minimum(lab, jnp.min(masked, axis=-1))
        # pointer-jump (path compression): lab[j] = lab[lab[j]] doubles
        # the reach (min within 2d: lab[j] is a node within distance d
        # whose own label is its min within distance d). Labels only
        # decrease toward the component min, so this is exact CC.
        # The jump is a one-hot einsum, not take_along_axis: a tiny
        # (.., C, C) contraction instead of per-row gathers. Exact:
        # labels stay < C (= 32) inside the loop - integers this small
        # are exactly representable in bf16, and each output row of the
        # one-hot product has exactly one nonzero term.
        oh = (lab[..., :, None]
              == jnp.arange(C, dtype=lab.dtype)).astype(jnp.bfloat16)
        jumped = jnp.einsum("...cj,...j->...c", oh,
                            lab.astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32
                            ).astype(jnp.int32)
        return jnp.minimum(lab, jumped)

    # reach after k rounds: d_{k+1} = 2(d_k + 1), so ceil(log2 C) + 2
    # rounds cover any diameter <= C (a C-step plain propagation spent
    # C full (.., C, C) passes)
    n_rounds = max(1, int(np.ceil(np.log2(max(C, 2)))) + 2)
    labels = jax.lax.fori_loop(0, n_rounds, body, labels)
    labels = jnp.where(mask, labels, C)

    slot = jax.lax.broadcasted_iota(jnp.int32, (C, C), 0)

    if max_cluster_size and max_cluster_size < C:
        # rank members by distance to their component's centroid; members
        # ranked >= cap become singletons (see docstring)
        M0 = (labels[..., None, :] == slot) & mask[..., None, :]
        cnt0 = jnp.maximum(jnp.sum(M0, axis=-1).astype(x.dtype), 1.0)
        cx0 = jnp.einsum("...rj,...j->...r", M0.astype(x.dtype), x) / cnt0
        cy0 = jnp.einsum("...rj,...j->...r", M0.astype(x.dtype), y) / cnt0
        ddx0 = x[..., None, :] - cx0[..., :, None]
        ddy0 = y[..., None, :] - cy0[..., :, None]
        dc = jnp.sqrt(ddx0 * ddx0 + ddy0 * ddy0)        # (..., r, j)
        # rank[r, j] = #{k in component r : (dc[r,k], k) < (dc[r,j], j)}.
        # The (r, k, j) comparison cube looks expensive but XLA tiles the
        # k-reduction without materializing it; a double-argsort
        # reformulation (2 sorts of the last axis) is the alternative,
        # not measured on a GPU yet.
        slot_j = jax.lax.broadcasted_iota(jnp.int32, (C, C), 1)
        A = dc[..., :, :, None]                          # (..., r, k, 1)
        B = dc[..., :, None, :]                          # (..., r, 1, j)
        k_lt_j = slot < slot_j                           # (k, j) index order
        closer = (A < B) | ((A == B) & k_lt_j)           # (..., r, k, j)
        in_comp = M0[..., :, :, None]                    # k in component r
        rank = jnp.sum(closer & in_comp, axis=-2)        # (..., r, j)
        my_rank = jnp.sum(jnp.where(M0, rank, 0), axis=-2)   # (..., j)
        kept = my_rank < max_cluster_size
        # relabel: kept members take the min KEPT index of their component
        # (the old min member may have been reverted to a singleton, and
        # singletons label as their own index - labels must not collide)
        iota_j = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
        same = labels[..., :, None] == labels[..., None, :]   # (j, k)
        cand = jnp.where(same & kept[..., None, :] & mask[..., None, :],
                         iota_j[..., None, :], C)
        core_lab = jnp.min(cand, axis=-1)
        labels = jnp.where(mask & kept, core_lab,
                           jnp.where(mask, iota_j, labels))

    # Membership matrix: M[r, j] = (labels[j] == r) & mask[j]
    M = (labels[..., None, :] == slot) & mask[..., None, :]

    # Gaussian-weighted representative per component
    # (EdgeClusterer.cpp:43-117)
    cnt = jnp.sum(M, axis=-1).astype(x.dtype)
    safe_cnt = jnp.maximum(cnt, 1.0)
    cen_x = jnp.einsum("...rj,...j->...r", M.astype(x.dtype), x) / safe_cnt
    cen_y = jnp.einsum("...rj,...j->...r", M.astype(x.dtype), y) / safe_cnt
    ddx = x[..., None, :] - cen_x[..., :, None]
    ddy = y[..., None, :] - cen_y[..., :, None]
    d_cen = jnp.sqrt(ddx * ddx + ddy * ddy)
    mean_shift = jnp.einsum("...rj,...rj->...r", M.astype(x.dtype), d_cen) / safe_cnt
    w = jnp.exp(-0.5 * ((d_cen - mean_shift[..., :, None]) / gauss_sigma) ** 2)
    w = w * M.astype(x.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1), 1e-12)
    gx = jnp.einsum("...rj,...j->...r", w, x) / wsum
    gy = jnp.einsum("...rj,...j->...r", w, y) / wsum
    gt = jnp.einsum("...rj,...j->...r", w, theta) / wsum

    rep_mask = (labels == jax.lax.broadcasted_iota(
        jnp.int32, x.shape, x.ndim - 1)) & mask
    return ClusterResult(
        x=jnp.where(rep_mask, gx, 0.0),
        y=jnp.where(rep_mask, gy, 0.0),
        theta=jnp.where(rep_mask, gt, 0.0),
        mask=rep_mask,
        label=labels,
        members=M,
    )
