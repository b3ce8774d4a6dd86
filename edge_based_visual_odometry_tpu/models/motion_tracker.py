"""Relative pose from quad pairs: constraint-gated 2-point RANSAC.

A fixed-shape re-design of the reference MotionTracker
(src/MotionTracker.cpp:28-253). The reference runs a sequential RANSAC
loop with rand() sampling, 4 rigid-invariance constraint gates, a
closed-form triad-alignment pose per 2-quad sample, O(N) reprojection
scoring per hypothesis, and adaptive iteration count.

Here all `max_iterations` hypotheses are drawn at once with jax.random,
gated by the constraints as a mask, solved as a batched closed-form pose,
and scored as one (K, Q) reprojection matrix; argmax picks the winner.
The adaptive early exit (ref :240-249) is unnecessary in batch mode - we
simply evaluate the full budget (strictly more hypotheses than the
reference would). Deterministic under a fixed seed (reference default
seed, include/MotionTracker.h:93-101).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as geom
from edge_based_visual_odometry_tpu.config import VOConfig
from edge_based_visual_odometry_tpu.models.temporal_matcher import TemporalQuads
from edge_based_visual_odometry_tpu.models.types import RigArrays, StereoMates


class PoseQuads(NamedTuple):
    """Flat lifted quads (Quad_for_Pose_Solution, MotionTracker.h:16-26)."""

    gamma: jnp.ndarray        # (Q, 3) KF 3D point
    gamma_bar: jnp.ndarray    # (Q, 3) CF 3D point
    tangent: jnp.ndarray      # (Q, 3)
    tangent_bar: jnp.ndarray  # (Q, 3)
    cf_left: jnp.ndarray      # (Q, 2) CF left center (scoring target)
    valid: jnp.ndarray        # (Q,) bool
    is_veridical: jnp.ndarray # (Q,) bool (eval-only; False without GT)
    n_valid: jnp.ndarray      # () int32


class RansacResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    inlier_count: jnp.ndarray
    inlier_ratio: jnp.ndarray
    n_quads: jnp.ndarray
    success: jnp.ndarray     # bool: >= 2 quads available (ref :177-182)


def lift_quads(kf: StereoMates, quads: TemporalQuads, rig: RigArrays,
               cfg: VOConfig, use_gt: bool) -> PoseQuads:
    """Lift every (KF mate, candidate) pair to (Gamma, Gamma_bar, T, T_bar)
    (get_Gammas_and_Tangents_From_Quads, ref :28-66) and rank-order PROSAC
    style by the row's candidate count ascending (ref :68-106).

    NOTE: the reference uses the LEFT K inverse for both left and right
    pixels here (ref :36-37, :52-53); reproduced deliberately.
    """
    M, Cq = quads.cmask.shape
    Kinv = rig.K_left_inv

    row_ok = quads.row_mask
    if use_gt:
        row_ok = row_ok & kf.is_tp   # ref :76-79

    # KF side (per row, broadcast over candidates)
    g1l = geom.pixel_to_ray(Kinv, jnp.stack([kf.left_x, kf.left_y], -1))
    g1r = geom.pixel_to_ray(Kinv, jnp.stack([kf.right_x, kf.right_y], -1))
    Gamma = geom.backproject_two_rays(rig.R21, rig.T21, g1l, g1r)
    t1 = geom.theta_to_ray_tangent(Kinv, kf.left_theta)
    t2 = geom.theta_to_ray_tangent(Kinv, kf.right_theta)
    T = geom.reconstruct_3d_tangent(rig.R21, g1l, g1r, t1, t2)

    # CF side per candidate
    gbl = geom.pixel_to_ray(Kinv, jnp.stack([quads.lcx, quads.lcy], -1))
    gbr = geom.pixel_to_ray(Kinv, jnp.stack([quads.rcx, quads.rcy], -1))
    Gamma_bar = geom.backproject_two_rays(rig.R21, rig.T21, gbl, gbr)
    t1b = geom.theta_to_ray_tangent(Kinv, quads.lct)
    t2b = geom.theta_to_ray_tangent(Kinv, quads.rct)
    T_bar = geom.reconstruct_3d_tangent(rig.R21, gbl, gbr, t1b, t2b)

    mask = quads.cmask & row_ok[:, None]
    n_cand_row = jnp.sum(mask, axis=1)

    # PROSAC ordering: (row candidate count asc, row, slot) - ref :92-103.
    # Only the first Q = max_pose_quads entries are consumed, and the key's
    # class domain (the row candidate count) is tiny, so a stable counting
    # sort replaces a 786k-key top_k (ops/sortfree.counting_sort_order).
    # Slots past
    # n_sel point at flat index 0 and are masked below via n_sel.
    from edge_based_visual_odometry_tpu.ops import sortfree as SF
    Qsel = min(cfg.max_pose_quads, M * Cq)
    cls = jnp.broadcast_to(n_cand_row[:, None], (M, Cq)).reshape(-1)
    order, n_sel = SF.counting_sort_order(
        cls, mask.reshape(-1), n_classes=Cq + 2, n_out=Qsel)

    def flat(a):
        return a.reshape(M * Cq, *a.shape[2:])[order]

    Gamma_f = jnp.broadcast_to(Gamma[:, None], (M, Cq, 3))
    T_f = jnp.broadcast_to(T[:, None], (M, Cq, 3))
    cf_left = jnp.stack([quads.lcx, quads.lcy], -1)
    # eval-only veridical flag per candidate quad (b_is_TP, ref :85)
    dl = jnp.sqrt((quads.lcx - quads.proj_left[:, 0:1]) ** 2
                  + (quads.lcy - quads.proj_left[:, 1:2]) ** 2)
    dr = jnp.sqrt((quads.rcx - quads.proj_right[:, 0:1]) ** 2
                  + (quads.rcy - quads.proj_right[:, 1:2]) ** 2)
    tp = quads.cmask & (dl < cfg.dist_to_gt_thresh_quads) \
        & (dr < cfg.dist_to_gt_thresh_quads)
    if not use_gt:
        tp = jnp.zeros_like(tp)
    # The PROSAC sort puts valid quads first; truncate the flat list to the
    # pose-quad budget so RANSAC scoring stays memory-bounded (valid count is
    # ~1-2 per KF row; overflow beyond the budget is dropped). The n_sel
    # gate kills the counting sort's zero-filled tail slots (which point
    # at flat index 0, a possibly-valid entry).
    Q = Qsel
    valid = (flat(mask)[:Q]
             & (jnp.arange(Q, dtype=jnp.int32) < n_sel))
    return PoseQuads(
        gamma=flat(Gamma_f)[:Q], gamma_bar=flat(Gamma_bar.reshape(M, Cq, 3))[:Q],
        tangent=flat(T_f)[:Q], tangent_bar=flat(T_bar.reshape(M, Cq, 3))[:Q],
        cf_left=flat(cf_left)[:Q], valid=valid,
        is_veridical=flat(tp)[:Q] & valid,
        n_valid=jnp.sum(valid).astype(jnp.int32))


def _pose_from_pair(g1, gb1, t1, tb1, g2, gb2, t2, tb2):
    """Closed-form triad alignment (estimate_Pose_From_a_Quad_Pair,
    ref :136-153). All args (..., 3)."""
    e1 = g2 - g1
    e1 = e1 / jnp.linalg.norm(e1, axis=-1, keepdims=True)
    e1b = gb2 - gb1
    e1b = e1b / jnp.linalg.norm(e1b, axis=-1, keepdims=True)
    u1 = t1 - jnp.sum(e1 * t1, -1, keepdims=True) * e1
    u1b = tb1 - jnp.sum(e1b * tb1, -1, keepdims=True) * e1b
    e2 = u1 / jnp.linalg.norm(u1, axis=-1, keepdims=True)
    e2b = u1b / jnp.linalg.norm(u1b, axis=-1, keepdims=True)
    e3 = jnp.cross(e1, e2)
    e3b = jnp.cross(e1b, e2b)
    B = jnp.stack([e1, e2, e3], -1)      # columns
    Bb = jnp.stack([e1b, e2b, e3b], -1)
    R = Bb @ jnp.swapaxes(B, -1, -2)
    t = gb1 - jnp.einsum("...ij,...j->...i", R, g1)
    return R, t


CONSTRAINT_STAGE_NAMES = (
    "Baseline", "Normalized Length Constraint", "T1 Angle Similarity Constraint",
    "T2 Angle Similarity Constraint", "Tangent Angle Similarity Constraint",
)


def _sample_quad_pairs(pq: PoseQuads, cfg: VOConfig, seed: int, K: int):
    """PROSAC-style top-rank pair sampling (ref :202-205 rand() draws from
    the top fraction; collision fix mirrors idx1 != idx2). Shared between
    estimate_pose and constraint_sweep_metrics so the diagnostic sweep
    always measures the gates RANSAC actually applies."""
    key = jax.random.PRNGKey(seed)
    top_n = jnp.maximum(
        (cfg.ransac_top_rank_percentage * pq.n_valid).astype(jnp.int32), 2)
    k1, k2 = jax.random.split(key)
    idx1 = jax.random.randint(k1, (K,), 0, 1 << 30) % top_n
    idx2 = jax.random.randint(k2, (K,), 0, 1 << 30) % top_n
    idx2 = jnp.where(idx2 == idx1, (idx2 + 1) % top_n, idx2)
    samples = (pq.gamma[idx1], pq.gamma_bar[idx1],
               pq.tangent[idx1], pq.tangent_bar[idx1],
               pq.gamma[idx2], pq.gamma_bar[idx2],
               pq.tangent[idx2], pq.tangent_bar[idx2])
    return idx1, idx2, samples


def _constraint_gates(samples, cfg: VOConfig):
    """The 4 rigid-motion invariance gates (Apply_*_Constraint,
    ref :108-134; thresholds definitions.h:47-50). Returns (c1, c2, c3,
    c4) boolean masks over the sampled pairs."""
    g1, gb1, t1, tb1, g2, gb2, t2, tb2 = samples
    dG = g2 - g1
    dGb = gb2 - gb1
    lG = jnp.linalg.norm(dG, axis=-1)
    lGb = jnp.linalg.norm(dGb, axis=-1)
    c1 = jnp.abs(lG - lGb) / lG < cfg.tau_c1
    c2 = jnp.abs(jnp.abs(jnp.sum(dG * t1, -1) / lG)
                 - jnp.abs(jnp.sum(dGb * tb1, -1) / lGb)) < cfg.tau_c2
    c3 = jnp.abs(jnp.abs(jnp.sum(dG * t2, -1) / lG)
                 - jnp.abs(jnp.sum(dGb * tb2, -1) / lGb)) < cfg.tau_c3
    c4 = jnp.abs(jnp.abs(jnp.sum(t1 * t2, -1))
                 - jnp.abs(jnp.sum(tb1 * tb2, -1))) < cfg.tau_c4
    return c1, c2, c3, c4


def constraint_sweep_metrics(pq: PoseQuads, cfg: VOConfig,
                             seed: int | None = None):
    """Diagnostic recall/precision of the 4 RANSAC constraint gates over
    random quad pairs (Solution_Constraints_Application,
    src/MotionTracker.cpp:255-381). Uses pq.is_veridical (eval mode).
    Returns (5, 3) rows [recall, precision, n_surviving_veridical]
    aligned with CONSTRAINT_STAGE_NAMES."""
    K = cfg.ransac_max_iterations
    idx1, idx2, samples = _sample_quad_pairs(
        pq, cfg, cfg.ransac_seed if seed is None else seed, K)
    ver = pq.is_veridical[idx1] & pq.is_veridical[idx2]
    c1, c2, c3, c4 = _constraint_gates(samples, cfg)
    gates = [jnp.ones((K,), bool), c1, c2, c3, c4]
    init_ver = jnp.sum(ver)
    rows = []
    surviving = jnp.ones((K,), bool)
    for g in gates:
        surviving = surviving & g
        n_surv = jnp.sum(surviving)
        n_ver = jnp.sum(surviving & ver)
        recall = n_ver / jnp.maximum(init_ver, 1)
        precision = n_ver / jnp.maximum(n_surv, 1)
        rows.append(jnp.stack([recall, precision,
                               n_ver.astype(jnp.float32)]))
    return jnp.stack(rows)


def estimate_pose(pq: PoseQuads, rig: RigArrays, cfg: VOConfig,
                  seed: int | None = None) -> RansacResult:
    """Vectorized constraint-gated RANSAC
    (estimate_Relative_Pose_From_Quad_Pairs, ref :175-253)."""
    K = cfg.ransac_max_iterations
    seed = cfg.ransac_seed if seed is None else seed
    idx1, idx2, samples = _sample_quad_pairs(pq, cfg, seed, K)
    c1, c2, c3, c4 = _constraint_gates(samples, cfg)
    gate = c1 & c2 & c3 & c4

    R, t = _pose_from_pair(*samples)

    # --- scoring (ref :155-173): chunked over hypotheses so the (K, Q)
    # reprojection matrix never materializes in device memory ---
    KG = jnp.einsum("ij,kjl->kil", rig.K_left, R)   # (K, 3, 3)
    Kt = jnp.einsum("ij,kj->ki", rig.K_left, t)     # (K, 3)
    chunk = 256

    def make_score(gamma, cf_left, valid):
        def score_chunk(args):
            KG_c, Kt_c = args
            uvw = (jnp.einsum("kij,qj->kqi", KG_c, gamma)
                   + Kt_c[:, None, :])
            uv = uvw[..., :2] / uvw[..., 2:3]
            err = jnp.linalg.norm(uv - cf_left[None], axis=-1)
            # cheirality: a behind-camera point whose doubly-negated
            # projection lands near the target must not count as an
            # inlier (mirror-pose guard; the reference divides by z
            # unchecked, score_Pose_Hypothesis MotionTracker.cpp:161-163
            # - a true pose only has positive-depth quads, so this gate
            # never hurts it)
            inl = ((err < cfg.ransac_max_reproj_error) & valid[None]
                   & (uvw[..., 2] > 1e-6))
            return jnp.sum(inl, axis=1)
        return score_chunk

    def score_all(KG_s, Kt_s, score_chunk):
        Ks = KG_s.shape[0]
        n_chunks = -(-Ks // chunk)
        pad = n_chunks * chunk - Ks
        KG_p = jnp.pad(KG_s, ((0, pad), (0, 0), (0, 0))).reshape(
            n_chunks, chunk, 3, 3)
        Kt_p = jnp.pad(Kt_s, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)
        return jax.lax.map(score_chunk, (KG_p, Kt_p)).reshape(-1)[:Ks]

    full_score = make_score(pq.gamma, pq.cf_left, pq.valid)
    Qs = cfg.ransac_prescore_quads
    if Qs and Qs < pq.gamma.shape[0]:
        # Preemptive two-stage scoring (VOConfig.ransac_prescore_quads):
        # rank every hypothesis on the TOP-Qs quads of the PROSAC
        # ordering (pq.* is PROSAC-sorted, valid-first), then score only
        # the best `keep` hypotheses on the full set.
        pre_score = make_score(pq.gamma[:Qs], pq.cf_left[:Qs],
                               pq.valid[:Qs])
        counts_pre = jnp.where(gate, score_all(KG, Kt, pre_score), -1)
        keep = min(cfg.ransac_prescore_keep, K)
        top_pre, top_idx = jax.lax.top_k(counts_pre, keep)
        counts_f = score_all(KG[top_idx], Kt[top_idx], full_score)
        counts_f = jnp.where(top_pre >= 0, counts_f, -1)
        best_local = jnp.argmax(counts_f)
        best = top_idx[best_local]
        best_raw = counts_f[best_local]
    else:
        counts = jnp.where(gate, score_all(KG, Kt, full_score), -1)
        best = jnp.argmax(counts)
        best_raw = counts[best]
    best_count = jnp.maximum(best_raw, 0)
    n_q = jnp.maximum(pq.n_valid, 1)
    success = pq.n_valid >= 2
    I = jnp.eye(3, dtype=R.dtype)
    R_best = jnp.where(success & (best_raw >= 0), R[best], I)
    t_best = jnp.where(success & (best_raw >= 0), t[best],
                       jnp.zeros(3, R.dtype))

    if cfg.ransac_refine:
        # DELIBERATE IMPROVEMENT over the reference (which returns the raw
        # 2-point closed-form winner, MotionTracker.cpp:233-236): refine
        # the winning pose by Gauss-Newton on the inlier reprojection
        # error (the same objective the hypotheses are scored with),
        # re-gating inliers each iteration.
        fx = rig.K_left[0, 0]
        fy = rig.K_left[1, 1]
        cx = rig.K_left[0, 2]
        cy = rig.K_left[1, 2]

        def gn_step(carry, _):
            Rr, tr = carry
            Xc = jnp.einsum("ij,qj->qi", Rr, pq.gamma) + tr
            z = jnp.maximum(Xc[:, 2], 1e-6)
            u = fx * Xc[:, 0] / z + cx
            v = fy * Xc[:, 1] / z + cy
            r = jnp.stack([u, v], -1) - pq.cf_left
            e = jnp.linalg.norm(r, axis=-1)
            w = ((e < cfg.ransac_max_reproj_error) & pq.valid).astype(
                jnp.float32)
            iz = 1.0 / z
            iz2 = iz * iz
            Jp = jnp.stack([
                jnp.stack([fx * iz, jnp.zeros_like(z), -fx * Xc[:, 0] * iz2], -1),
                jnp.stack([jnp.zeros_like(z), fy * iz, -fy * Xc[:, 1] * iz2], -1),
            ], axis=1)                                   # (Q, 2, 3)
            Xh = geom.skew(Xc)
            J_om = -jnp.einsum("qij,qjk->qik", Jp, Xh)
            J = jnp.concatenate([J_om, Jp], axis=-1)     # (Q, 2, 6)
            H = jnp.einsum("q,qia,qib->ab", w, J, J) + 1e-6 * jnp.eye(6)
            b = -jnp.einsum("q,qia,qi->a", w, J, r)
            dp = jnp.linalg.solve(H, b)
            dR = geom.so3_exp(dp[:3])
            ok = jnp.sum(w) >= 3
            Rn = jnp.where(ok, dR @ Rr, Rr)
            tn = jnp.where(ok, dR @ tr + dp[3:], tr)
            return (Rn, tn), None

        (Rr, tr), _ = jax.lax.scan(gn_step, (R_best, t_best), None, length=4)
        # Accept unless the refinement degenerated (GN minimizes squared
        # error, so the hard inlier COUNT may drop by a few boundary
        # points while the pose improves substantially).
        p = jnp.einsum("ij,qj->qi", Rr, pq.gamma) + tr
        uvw = jnp.einsum("ij,qj->qi", rig.K_left, p)
        uv = uvw[:, :2] / uvw[:, 2:3]
        e = jnp.linalg.norm(uv - pq.cf_left, axis=-1)
        cnt_f = jnp.sum((e < cfg.ransac_max_reproj_error) & pq.valid
                        & (uvw[:, 2] > 1e-6))   # cheirality (see scoring)
        finite = jnp.all(jnp.isfinite(Rr)) & jnp.all(jnp.isfinite(tr))
        ok_refined = finite & (cnt_f >= (0.8 * best_count).astype(cnt_f.dtype))
        R_best = jnp.where(success & ok_refined, Rr, R_best)
        t_best = jnp.where(success & ok_refined, tr, t_best)
        best_count = jnp.where(success & ok_refined, cnt_f, best_count)

    return RansacResult(
        R=R_best,
        t=t_best,
        inlier_count=best_count,
        inlier_ratio=best_count / n_q,
        n_quads=pq.n_valid,
        success=success)
