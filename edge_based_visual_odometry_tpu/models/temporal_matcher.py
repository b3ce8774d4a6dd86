"""Temporal quad matching: KF stereo mates <-> CF stereo mates.

A fixed-shape re-design of the reference's Temporal_Matches engine
(src/Temporal_Matches.cpp). A "quad" associates one keyframe stereo edge
mate with one current-frame stereo edge mate (4 edges of one 3D point).
The reference builds pointer-linked Candidate_Quad_Entry lists; here the
state is a fixed-shape (M_kf, MAX_QUAD_CAND) tensor keyed by CF mate index.

Cascade (get_Temporal_Edge_Pairs_from_Quads, ref :168-218):
  grid gathering radius 30 around the KF edge locations  (ref :335-383)
  orientation both sides 10 deg                           (ref :385-414)
  NCC both sides > 0.8 from stored patches                (ref :416-469)
  descriptor both sides < 200 from stored descriptors     (ref :471-515)
  best/nearly-best on NCC then descriptor (left scores)   (ref :517-570)
  2-DoF photometric GN both sides                         (ref :572-634)
  clustering of left centers + right-side averaging       (ref :636-733)

Veridical quads for evaluation project the KF 3D point with the GT
relative pose and transport the 3D tangent for orientation prediction
(build_Veridical_Quads ref :57-166, orientation_mapping ref :294-333);
the production path uses the same machinery with a predicted pose.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as geom
from edge_based_visual_odometry_tpu.config import VOConfig
from edge_based_visual_odometry_tpu.models.types import FrameData, RigArrays, StereoMates
from edge_based_visual_odometry_tpu.ops import clustering as CL
from edge_based_visual_odometry_tpu.ops import descriptors as DESC
from edge_based_visual_odometry_tpu.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu.ops import grid as GRID
from edge_based_visual_odometry_tpu.ops import patches as P

TEMPORAL_STAGE_NAMES = (
    "Location Proximity", "Orientation", "NCC", "SIFT",
    "BNB-NCC", "BNB-SIFT", "Photometric Refinement", "Edge Clustering",
)


class TemporalQuads(NamedTuple):
    """Fixed-shape quad candidate state. Rows align with KF mate slots."""

    row_mask: jnp.ndarray       # (M,) KF mates participating
    # GT/predicted projections of the KF 3D point into the CF (eval +
    # veridical bookkeeping; ref KF_Temporal_Edge_Quads :17-30)
    proj_left: jnp.ndarray      # (M, 2)
    proj_right: jnp.ndarray     # (M, 2)
    proj_theta_l: jnp.ndarray   # (M,)
    proj_theta_r: jnp.ndarray   # (M,)
    has_veridical: jnp.ndarray  # (M,) bool: >= 1 veridical CF mate exists
    # candidates (M, Cq): CF mate index + left/right cluster centers
    cf_idx: jnp.ndarray
    lcx: jnp.ndarray
    lcy: jnp.ndarray
    lct: jnp.ndarray
    rcx: jnp.ndarray
    rcy: jnp.ndarray
    rct: jnp.ndarray
    cmask: jnp.ndarray
    ncc_l: jnp.ndarray          # left-side NCC score (BNB key)
    desc_l: jnp.ndarray         # left-side descriptor distance


def _quad_metrics(q: TemporalQuads, kf_is_tp, dist_thresh: float):
    """Evaluate_Temporal_Edge_Pairs_on_Quads (ref :220-292). Rows counted
    only where the KF mate is a true positive."""
    rows = q.row_mask & kf_is_tp
    dl = jnp.sqrt((q.lcx - q.proj_left[:, 0:1]) ** 2
                  + (q.lcy - q.proj_left[:, 1:2]) ** 2)
    dr = jnp.sqrt((q.rcx - q.proj_right[:, 0:1]) ** 2
                  + (q.rcy - q.proj_right[:, 1:2]) ** 2)
    tp = q.cmask & (dl < dist_thresh) & (dr < dist_thresh)
    n_tp = jnp.sum(tp, 1)
    n_c = jnp.sum(q.cmask, 1)
    has_c = rows & (n_c > 0)
    n_rows = jnp.maximum(jnp.sum(rows), 1)
    n_rows_c = jnp.maximum(jnp.sum(has_c), 1)
    recall = jnp.sum(rows & (n_tp > 0)) / n_rows
    precision = jnp.sum(
        jnp.where(has_c, n_tp / jnp.maximum(n_c, 1), 0.0)) / n_rows_c
    ambiguity = jnp.sum(jnp.where(has_c, n_c, 0)) / n_rows_c - 1.0
    return jnp.stack([recall, precision, precision, ambiguity])


def _project_kf_points(kf: StereoMates, rel: geom.Pose, rig: RigArrays,
                       use_gt_gamma: bool):
    """Project KF 3D points + transported tangents into the CF
    (build_Veridical_Quads ref :78-96, orientation_mapping ref :294-333)."""
    gamma = kf.gamma_gt if use_gt_gamma else kf.gamma
    g_cf_l = rel.transform(gamma)
    pl = geom.project(rig.K_left, g_cf_l)
    g_cf_r = jnp.einsum("ij,nj->ni", rig.R21, g_cf_l) + rig.T21
    pr = geom.project(rig.K_right, g_cf_r)

    # 3D tangent from the KF stereo pair; note the reference uses the LEFT
    # K inverse for both sides here (ref :304-310 uses per-camera K; the
    # pose stage at MotionTracker.cpp:36 uses left-only; we follow
    # orientation_mapping and use per-camera K).
    g1 = geom.pixel_to_ray(rig.K_left_inv, jnp.stack([kf.left_x, kf.left_y], -1))
    g2 = geom.pixel_to_ray(rig.K_right_inv, jnp.stack([kf.right_x, kf.right_y], -1))
    t1 = geom.theta_to_ray_tangent(rig.K_left_inv, kf.left_theta)
    t2 = geom.theta_to_ray_tangent(rig.K_right_inv, kf.right_theta)
    T1 = geom.reconstruct_3d_tangent(rig.R21, g1, g2, t1, t2)
    T2_l = rel.rotate(T1)
    T2_r = jnp.einsum("ij,nj->ni", rig.R21, T2_l)
    gl = geom.pixel_to_ray(rig.K_left_inv, pl)
    gr = geom.pixel_to_ray(rig.K_right_inv, pr)
    tl = geom.project_3d_tangent_to_2d(T2_l, gl)
    tr = geom.project_3d_tangent_to_2d(T2_r, gr)
    th_l = jnp.arctan2(tl[..., 1], tl[..., 0])
    th_r = jnp.arctan2(tr[..., 1], tr[..., 0])
    return pl, pr, th_l, th_r


def match_temporal(kf: StereoMates, cf: StereoMates,
                   kf_frame: FrameData, cf_frame: FrameData,
                   rel_pose: geom.Pose, rig: RigArrays, cfg: VOConfig,
                   use_gt: bool):
    """Run the quad cascade. rel_pose: KF->CF relative pose (GT in eval
    mode, predicted in production). Returns (TemporalQuads, metrics) with
    metrics (n_stages, 4) rows aligned to TEMPORAL_STAGE_NAMES."""
    M = cfg.max_mates
    Cq = cfg.max_quad_candidates
    H, W = cf_frame.left.shape
    margin = 10.0

    pl, pr, th_l, th_r = _project_kf_points(kf, rel_pose, rig,
                                            use_gt_gamma=use_gt)
    in_img = ((pl[:, 0] > margin) & (pl[:, 1] > margin)
              & (pl[:, 0] < W - margin) & (pl[:, 1] < H - margin)
              & (pr[:, 0] > margin) & (pr[:, 1] > margin)
              & (pr[:, 0] < W - margin) & (pr[:, 1] < H - margin))

    # CF mate spatial indices over left and right edge locations
    # 8 px bands: CF mates concentrate along ridges, so wide bands
    # overflow their fixed gather slots in dense rows
    band_h = 8
    cf_attrs = jnp.stack([cf.left_x, cf.left_y, cf.left_theta,
                          cf.right_x, cf.right_y, cf.right_theta], -1)
    lgrid = GRID.build_sorted_grid(cf.left_x, cf.left_y, cf.valid, W, H,
                                   band_h=band_h, attrs=cf_attrs)

    # ---- veridical quads (ref :57-166): exact distance < 2 px both sides
    # + orientation gates vs the transported orientation ----
    r_v = cfg.dist_to_gt_thresh_quads + 1.0
    vwin = int(-(-2 * r_v // band_h)) + 1
    _, v_at, vmask = GRID.query_sorted_grid_attrs(
        lgrid, pl[:, 0], pl[:, 1], rx=r_v, ry=r_v,
        slots_per_band=8, n_band_window=vwin)
    v_dl = jnp.sqrt((v_at[0] - pl[:, 0:1]) ** 2
                    + (v_at[1] - pl[:, 1:2]) ** 2)
    v_dr = jnp.sqrt((v_at[3] - pr[:, 0:1]) ** 2
                    + (v_at[4] - pr[:, 1:2]) ** 2)
    v_ol = geom.orientation_diff_deg(th_l[:, None], v_at[2])
    v_or = geom.orientation_diff_deg(th_r[:, None], v_at[5])
    # NOTE: no cf.valid[vidx] term - query_sorted_grid_attrs guarantees
    # masked slots are valid entries (invalid keys sort past every
    # window), so a pred gather over the window would be redundant
    vmask = (vmask
             & (v_dl < cfg.dist_to_gt_thresh_quads)
             & (v_dr < cfg.dist_to_gt_thresh_quads)
             & geom.orientation_gate(v_ol, cfg.veridical_orient_thresh_deg)
             & geom.orientation_gate(v_or, cfg.veridical_orient_thresh_deg))
    has_verid = jnp.any(vmask, axis=1)

    row_mask = kf.valid & in_img
    if use_gt:
        # the reference only keeps KF rows that formed veridical quads
        # (thread_quads push condition, ref :146-156)
        row_mask = row_mask & has_verid

    # ---- candidate gathering, left AND right box membership = the
    # reference's left/right cell-set intersection
    # (apply_spatial_grid_filtering_quads ref :335-383).
    # As in the stereo cascade, the cheap gates (box + orientation) run on
    # the RAW gather window and compaction to Cq happens afterwards with
    # a distance-to-prediction priority, so the fixed capacity only bites
    # where post-orientation ambiguity would exceed Cq (the reference has
    # no capacity at all).
    # Window placement: eval/parity mode mirrors the reference - radius
    # 30 around the KF locations, absorbing the full inter-frame motion
    # (ref :184). Production mode centers the window at the PREDICTED
    # projections (pl, pr) instead: the window then only absorbs
    # prediction error (acceleration-bounded), so radius and slots
    # shrink ~4x (deviation, see VOConfig.temporal_gather_mode). ----
    if use_gt or cfg.temporal_gather_mode == "reference":
        r_g = cfg.temporal_grid_radius
        n_slots = cfg.quad_gather_slots
        gl_x, gl_y = kf.left_x, kf.left_y
        gr_x, gr_y = kf.right_x, kf.right_y
    else:
        r_g = cfg.temporal_grid_radius_prod
        n_slots = cfg.quad_gather_slots_prod
        gl_x, gl_y = pl[:, 0], pl[:, 1]
        gr_x, gr_y = pr[:, 0], pr[:, 1]
    gwin = int(-(-2 * r_g // band_h)) + 1
    gidx, g_at, gmask = GRID.query_sorted_grid_attrs(
        lgrid, gl_x, gl_y, rx=r_g, ry=r_g,
        slots_per_band=-(-n_slots // gwin), n_band_window=gwin)
    g_rdx = jnp.abs(g_at[3] - gr_x[:, None])
    g_rdy = jnp.abs(g_at[4] - gr_y[:, None])
    gmask = (gmask & row_mask[:, None]     # validity via the query mask
             & (g_rdx <= r_g) & (g_rdy <= r_g))

    metrics = []

    def _count_row(mask):
        """Production-mode stage diagnostics: [rows with >=1 candidate,
        total candidates, 0, 0] - mirrors the stereo cascade, makes
        silent quad-cascade collapse visible without GT."""
        return jnp.stack([jnp.sum(jnp.any(mask, 1)).astype(jnp.float32),
                          jnp.sum(mask).astype(jnp.float32),
                          jnp.float32(0.0), jnp.float32(0.0)])

    def record_raw(mask):
        if not use_gt:
            metrics.append(_count_row(mask))
            return
        tmp = TemporalQuads(
            row_mask=row_mask, proj_left=pl, proj_right=pr,
            proj_theta_l=th_l, proj_theta_r=th_r, has_veridical=has_verid,
            cf_idx=gidx, lcx=g_at[0], lcy=g_at[1],
            lct=g_at[2], rcx=g_at[3],
            rcy=g_at[4], rct=g_at[5], cmask=mask,
            ncc_l=None, desc_l=None)
        metrics.append(_quad_metrics(tmp, kf.is_tp,
                                     cfg.dist_to_gt_thresh_quads))

    record_raw(gmask)

    # ---- orientation both sides on the raw window (ref :385-414) ----
    g_ol = geom.orientation_diff_deg(kf.left_theta[:, None], g_at[2])
    g_or = geom.orientation_diff_deg(kf.right_theta[:, None], g_at[5])
    gmask = (gmask
             & geom.orientation_gate(g_ol, cfg.temporal_orient_thresh_deg)
             & geom.orientation_gate(g_or, cfg.temporal_orient_thresh_deg))
    record_raw(gmask)

    # Compaction priority: distance of the candidate CF mate to the
    # PREDICTED (projected) KF location, both sides. The veridical
    # criterion is exactly proximity to the projection
    # (Temporal_Matches.cpp:64-68), so nearest-to-prediction ranking
    # preserves the true candidate whenever the raw window held it;
    # orientation-difference ranking (the earlier heuristic) lost ~30%
    # of veridical candidates at ambiguity >> Cq (caught by
    # tests/test_ref_binary_e2e.py against the reference binary).
    d_l = jnp.hypot(g_at[0] - pl[:, None, 0],
                    g_at[1] - pl[:, None, 1])
    d_r = jnp.hypot(g_at[3] - pr[:, None, 0],
                    g_at[4] - pr[:, None, 1])
    cf_idx, c_at, cmask = GRID.compact_candidates_attrs(
        gidx, g_at, gmask, Cq, priority=d_l + d_r)
    q = TemporalQuads(
        row_mask=row_mask, proj_left=pl, proj_right=pr,
        proj_theta_l=th_l, proj_theta_r=th_r, has_veridical=has_verid,
        cf_idx=cf_idx,
        lcx=c_at[0], lcy=c_at[1], lct=c_at[2],
        rcx=c_at[3], rcy=c_at[4], rct=c_at[5],
        cmask=cmask,
        ncc_l=jnp.full((M, Cq), -1.0, jnp.float32),
        desc_l=jnp.full((M, Cq), 900.0, jnp.float32),
    )

    def record(qq):
        metrics.append(_quad_metrics(qq, kf.is_tp, cfg.dist_to_gt_thresh_quads)
                       if use_gt else _count_row(qq.cmask))

    # ---- NCC + descriptor gates, both sides (ref :416-515) ----
    # ONE wide row gather for both sides: at these row widths gather
    # cost has a per-row part, so the concatenated [left | right] patch
    # rows (1568 B) are fetched once instead of in two 784 B gathers of
    # the same bytes.
    # Two layouts (cfg.temporal_gate_layout):
    #   "dense": full (M, Cq) computation (every slot, masked later);
    #   "flat":  compact active (row, slot) pairs to a flat list first -
    #            gather volume and NCC/desc work scale with the ~20%
    #            post-orientation occupancy instead of M*Cq, chunk
    #            skipping frees the budget tail. Results identical for
    #            live slots; budget-overflow actives stay alive with
    #            just-passing scores (the stereo flat-gate rule).
    pp_n = cfg.patch_size * cfg.patch_size
    two = 2 * pp_n
    cf_pat_lr = jnp.concatenate([cf.left_patches, cf.right_patches], -1)
    cok_lr_src = jnp.concatenate([cf.left_patch_ok, cf.right_patch_ok], -1)
    cf_desc_lr = jnp.concatenate([cf.left_desc, cf.right_desc], -1)
    D2 = cf.left_desc.shape[-1]

    # patch payload ships as bf16 PAIRS bitcast into f32 carrier rows in
    # BOTH layouts: half the gather bytes of the dominant temporal fetch
    # at 32-bit row-gather granularity (direct sub-32-bit gathers were
    # slower where this was tuned; not measured on a GPU yet). Patch
    # values are bilinear samples of 0..255 images;
    # bf16 rounds them at ~0.2 gray, moving NCC scores by ~1e-4 against
    # gates at 0.8 (quality-gated by the bench workload record).
    n_cf = cf_pat_lr.shape[0]
    cf_pat_packed = jax.lax.bitcast_convert_type(
        cf_pat_lr.astype(jnp.bfloat16).reshape(n_cf, -1, 2),
        jnp.float32)                                    # (N_cf, 2*P*P)

    def _unpack(rows_f32):
        flat = jax.lax.bitcast_convert_type(rows_f32, jnp.bfloat16)
        return flat.reshape(*rows_f32.shape[:-1], -1).astype(jnp.float32)

    if cfg.temporal_gate_layout == "flat":
        from edge_based_visual_odometry_tpu.models.stereo_matcher import (
            _flatten_active as _fa, _scatter_back as _sb)
        from edge_based_visual_odometry_tpu.ops import tiled_sampling as TS
        budget = min(cfg.temporal_gate_pairs, M * Cq)
        rows6, slots6, fmask6 = _fa(q.cmask, budget)
        cfi6 = q.cf_idx[rows6, slots6]

        def _gate_chunk(args):
            rows_c, cfi_c = args
            cp = _unpack(cf_pat_packed[cfi_c])
            cok = cok_lr_src[cfi_c]
            kl = kf.left_patches[rows_c]
            klok = kf.left_patch_ok[rows_c]
            kr = kf.right_patches[rows_c]
            krok = kf.right_patch_ok[rows_c]
            sl = P.ncc4(kl[:, :pp_n], kl[:, pp_n:], klok[:, 0], klok[:, 1],
                        cp[:, :pp_n], cp[:, pp_n:two], cok[:, 0], cok[:, 1])
            sr = P.ncc4(kr[:, :pp_n], kr[:, pp_n:], krok[:, 0], krok[:, 1],
                        cp[:, two:two + pp_n], cp[:, two + pp_n:],
                        cok[:, 2], cok[:, 3])
            cd = cf_desc_lr[cfi_c]
            dl_c = DESC.min_cross_distance_dot(
                kf.left_desc[rows_c], cd[:, None, :D2])[:, 0]
            dr_c = DESC.min_cross_distance_dot(
                kf.right_desc[rows_c], cd[:, None, D2:])[:, 0]
            return jnp.stack([sl, sr, dl_c, dr_c], -1)

        out = TS.map_chunked(_gate_chunk, (rows6, cfi6), budget,
                             cfg.gate_chunk, active=fmask6)
        ncc_pass = cfg.temporal_ncc_thresh + 1e-6
        sift_pass = cfg.temporal_sift_thresh * (1.0 - 1e-6)
        sim_l = _sb(jnp.full((M, Cq), ncc_pass, jnp.float32),
                    rows6, slots6, fmask6, out[:, 0])
        sim_r = _sb(jnp.full((M, Cq), ncc_pass, jnp.float32),
                    rows6, slots6, fmask6, out[:, 1])
        dl = _sb(jnp.full((M, Cq), sift_pass, jnp.float32),
                 rows6, slots6, fmask6, out[:, 2])
        dr = _sb(jnp.full((M, Cq), sift_pass, jnp.float32),
                 rows6, slots6, fmask6, out[:, 3])
    else:
        cpat_lr = _unpack(cf_pat_packed[q.cf_idx])   # (M, Cq, 2 * 2*P*P)
        cok_lr = cok_lr_src[q.cf_idx]                   # (M, Cq, 4)

        def side_ncc(kf_patches, kf_ok, cpat, cok):
            return P.ncc4(kf_patches[:, None, :pp_n],
                          kf_patches[:, None, pp_n:],
                          kf_ok[:, None, 0], kf_ok[:, None, 1],
                          cpat[:, :, :pp_n], cpat[:, :, pp_n:],
                          cok[:, :, 0], cok[:, :, 1])
        sim_l = side_ncc(kf.left_patches, kf.left_patch_ok,
                         cpat_lr[:, :, :two], cok_lr[:, :, :2])
        sim_r = side_ncc(kf.right_patches, kf.right_patch_ok,
                         cpat_lr[:, :, two:], cok_lr[:, :, 2:])
        cdesc_lr = cf_desc_lr[q.cf_idx]                 # (M, Cq, 2*D)
        dl = DESC.min_cross_distance_dot(kf.left_desc, cdesc_lr[..., :D2])
        dr = DESC.min_cross_distance_dot(kf.right_desc, cdesc_lr[..., D2:])

    q = q._replace(cmask=q.cmask & (sim_l > cfg.temporal_ncc_thresh)
                   & (sim_r > cfg.temporal_ncc_thresh),
                   ncc_l=sim_l)
    record(q)

    q = q._replace(cmask=q.cmask & (dl < cfg.temporal_sift_thresh)
                   & (dr < cfg.temporal_sift_thresh),
                   desc_l=dl)
    record(q)

    # ---- BNB on left-side scores (ref :517-570) ----
    from edge_based_visual_odometry_tpu.models.stereo_matcher import _bnb_keep
    q = q._replace(cmask=_bnb_keep(q.ncc_l, q.cmask, cfg.temporal_bnb_ratio,
                                   higher_better=True))
    record(q)
    q = q._replace(cmask=_bnb_keep(q.desc_l, q.cmask, cfg.temporal_bnb_ratio,
                                   higher_better=False))
    record(q)

    # ---- 2-DoF photometric refinement, both sides (ref :572-634) ----
    from edge_based_visual_odometry_tpu.models.stereo_matcher import (
        _flatten_active, _scatter_back)
    rows, slots, fmask = _flatten_active(q.cmask, cfg.max_refine_pairs)
    # packed flat-list fetches: one row gather per side instead of six
    # narrow 131072-element gathers
    kf_pack = jnp.stack([kf.left_x, kf.left_y, kf.left_theta,
                         kf.right_x, kf.right_y, kf.right_theta],
                        -1)[rows]                        # (B, 6)
    c_pack = jnp.stack([q.lcx, q.lcy, q.lct, q.rcx, q.rcy, q.rct],
                       -1).reshape(M * Cq, 6)[rows * Cq + slots]

    def refine_side(kf_img, cf_img, cf_gx, cf_gy, o):
        return GN.refine_2dof_batch(
            kf_img, cf_img, cf_gx, cf_gy,
            kf_pack[:, o], kf_pack[:, o + 1], kf_pack[:, o + 2],
            c_pack[:, o], c_pack[:, o + 1], c_pack[:, o + 2],
            patch_size=cfg.patch_size, max_iter=cfg.gn_max_iter,
            tol=cfg.gn_tol, huber_delta=cfg.temporal_huber_delta,
            tile=cfg.gn_tile, chunk=cfg.gn_chunk, active=fmask,
            phase1_iters=cfg.gn_phase1_iters,
            phase2_budget=cfg.gn_phase2_budget,
            phase1_chunk=cfg.gn_phase1_chunk,
            weight_split=cfg.gn_weight_split)

    res_l = refine_side(kf_frame.left, cf_frame.left,
                        cf_frame.left_gx, cf_frame.left_gy, 0)
    res_r = refine_side(kf_frame.right, cf_frame.right,
                        cf_frame.right_gx, cf_frame.right_gy, 3)
    # refined location = kf - d, applied per side when that side is valid
    # (ref :622-631)
    new_lx = jnp.where(res_l.valid, kf_pack[:, 0] - res_l.delta[:, 0],
                       c_pack[:, 0])
    new_ly = jnp.where(res_l.valid, kf_pack[:, 1] - res_l.delta[:, 1],
                       c_pack[:, 1])
    new_rx = jnp.where(res_r.valid, kf_pack[:, 3] - res_r.delta[:, 0],
                       c_pack[:, 3])
    new_ry = jnp.where(res_r.valid, kf_pack[:, 4] - res_r.delta[:, 1],
                       c_pack[:, 4])
    q = q._replace(
        lcx=_scatter_back(q.lcx, rows, slots, fmask, new_lx),
        lcy=_scatter_back(q.lcy, rows, slots, fmask, new_ly),
        rcx=_scatter_back(q.rcx, rows, slots, fmask, new_rx),
        rcy=_scatter_back(q.rcy, rows, slots, fmask, new_ry))
    record(q)

    # ---- clustering: left centers with orientation gate; right centers
    # averaged over cluster members (ref :636-733) ----
    cl = CL.cluster_edges(q.lcx, q.lcy, q.lct, q.cmask,
                          dist_thresh=cfg.cluster_dist_thresh,
                          orient_thresh_deg=cfg.cluster_orient_thresh,
                          by_orientation=True,
                          gauss_sigma=cfg.cluster_orient_gauss_sigma,
                          max_cluster_size=cfg.max_cluster_size)
    Mw = cl.members.astype(jnp.float32)
    cnt = jnp.maximum(jnp.sum(Mw, -1), 1.0)
    avg_rx = jnp.einsum("mrj,mj->mr", Mw, q.rcx) / cnt
    avg_ry = jnp.einsum("mrj,mj->mr", Mw, q.rcy) / cnt
    avg_rt = jnp.einsum("mrj,mj->mr", Mw, q.rct) / cnt
    q = q._replace(
        lcx=jnp.where(cl.mask, cl.x, q.lcx),
        lcy=jnp.where(cl.mask, cl.y, q.lcy),
        lct=jnp.where(cl.mask, cl.theta, q.lct),
        rcx=jnp.where(cl.mask, avg_rx, q.rcx),
        rcy=jnp.where(cl.mask, avg_ry, q.rcy),
        rct=jnp.where(cl.mask, avg_rt, q.rct),
        cmask=cl.mask)
    record(q)

    return q, jnp.stack(metrics)
