"""Stereo edge matching: the 11-stage filter cascade as masked tensor passes.

A fixed-shape re-design of the reference's Stereo_Matches engine
(src/Stereo_Matches.cpp:1360-1540 orchestration). The reference threads
dynamically-sized candidate vectors through erase-based filters; here the
state is one fixed-shape (N_left, MAX_CAND) candidate tensor with a
monotone validity mask (SURVEY.md §7 "dynamic-shape elimination"), and each
stage is a batched masked kernel:

  stage 1  epipolar distance       (ref :381-419)  - at grid gathering
  stage 2  max disparity           (ref :534-553)
  stage 3  orientation             (ref :863-915)
  stage 4  descriptor gate         (ref :655-787, SIFT -> our
                                    gradient-histogram descriptor)
  stage 5  NCC                     (ref :555-616)
  stage 6  best/nearly-best NCC    (ref :789-862)
  stage 7  best/nearly-best desc   (ref :789-862)
  stage 8  epipolar shift          (ref :26-89, :967-1037)
  stage 9  1-DoF photometric GN    (ref :1159-1358)
  stage 10 clustering              (ref :1010-1035 -> ops/clustering.py)
  stage 11 post-cluster NCC        (ref :1500)
  stage 12 best-only pick          (ref :916-965)
  cleanup  empty-row purge         (ref :1543-1576)

GT supervision (veridical sets from GT disparity, per-stage
recall/precision/ambiguity) mirrors Find_Stereo_GT_Locations /
get_Stereo_Edge_GT_Pairs / Evaluate_Stereo_Edge_Correspondences
(ref :133-379).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
from edge_based_visual_odometry_tpu.ops import sortfree as SF
from edge_based_visual_odometry_tpu.ops.toed import EdgeList

# Stage names in cascade order (metric keys; reference stage labels at
# Stereo_Matches.cpp:1382-1535).
STAGE_NAMES = (
    "Epipolar Proximity", "Location Proximity", "Orientation", "SIFT", "NCC",
    "BNB-NCC", "BNB-SIFT", "Photometric Refinement", "Edge Clustering",
    "NCC-Post", "Best", "Final",
)


class StereoState(NamedTuple):
    """Cascade state: left focused-edge rows x candidate slots."""

    # rows (N,)
    row_mask: jnp.ndarray
    lx: jnp.ndarray
    ly: jnp.ndarray
    ltheta: jnp.ndarray
    epi_line: jnp.ndarray        # (N, 3)
    gt_x: jnp.ndarray
    gt_y: jnp.ndarray
    gamma_gt_l: jnp.ndarray      # (N, 3)
    gamma_gt_r: jnp.ndarray      # (N, 3)
    # candidates (N, C)
    cand_idx: jnp.ndarray        # right TOED index (pre-cluster semantics)
    cx: jnp.ndarray
    cy: jnp.ndarray
    ctheta: jnp.ndarray
    cmask: jnp.ndarray
    ncc: jnp.ndarray             # refine_final_scores role
    desc_dist: jnp.ndarray       # refine_confidences role


def _metrics(state: StereoState, dist_to_gt: float):
    """Per-stage recall/precision/ambiguity
    (Evaluate_Stereo_Edge_Correspondences, Stereo_Matches.cpp:270-379)."""
    d = jnp.sqrt((state.cx - state.gt_x[:, None]) ** 2
                 + (state.cy - state.gt_y[:, None]) ** 2)
    tp = state.cmask & (d <= dist_to_gt)
    n_tp = jnp.sum(tp, axis=1)
    n_cand = jnp.sum(state.cmask, axis=1)
    has_cand = state.row_mask & (n_cand > 0)
    rows = jnp.maximum(jnp.sum(state.row_mask), 1)
    rows_with = jnp.maximum(jnp.sum(has_cand), 1)
    prec_edge = jnp.where(n_cand > 0, n_tp / jnp.maximum(n_cand, 1), 0.0)
    recall = jnp.sum(state.row_mask & (n_tp > 0)) / rows
    precision = jnp.sum(jnp.where(state.row_mask, prec_edge, 0.0)) / rows
    precision_pair = jnp.sum(jnp.where(has_cand, prec_edge, 0.0)) / rows_with
    ambiguity = jnp.sum(jnp.where(has_cand, n_cand, 0)) / rows_with
    return jnp.stack([recall, precision, precision_pair, ambiguity])


def _bnb_keep(scores, mask, ratio_thresh: float, higher_better: bool):
    """Best/nearly-best streak filter (Stereo_Matches.cpp:789-862).

    Sort candidates (best first), keep rank 0 plus every rank whose
    ratio to the BEST passes the threshold, stopping at the first failure
    (cumulative AND reproduces the reference's early break)."""
    C = scores.shape[-1]
    big = jnp.float32(3.4e38)
    if higher_better:
        key = jnp.where(mask, -scores, big)
    else:
        key = jnp.where(mask, scores, big)
    # one comparison-count pass yields the ascending rank; sorted views
    # and the write-back are one-hot dot_generals - no sorts, no per-row
    # gathers (XLA paid two bitonic sorts + three take_along gathers
    # here; ops/sortfree.py)
    rank = SF.rank_desc_rows(-key)
    sm = SF.compact_by_rank(rank, C, jnp.stack(
        [scores, mask.astype(jnp.float32)]))
    s_sorted = sm[0]
    m_sorted = sm[1] > 0.5
    best = s_sorted[..., 0:1]
    if higher_better:
        ratio = s_sorted / best
    else:
        ratio = best / s_sorted
    ok = (ratio >= ratio_thresh) & m_sorted & (best != 0.0)
    ok = ok.at[..., 0].set(m_sorted[..., 0])
    keep_sorted = jnp.cumprod(ok.astype(jnp.int32), axis=-1).astype(bool)
    # rows with < 2 candidates are untouched (ref :801)
    n_cand = jnp.sum(mask, axis=-1, keepdims=True)
    keep_sorted = jnp.where(n_cand < 2, m_sorted, keep_sorted)
    # map keep flags back to original slot order via the rank one-hot
    keep = SF.expand_by_rank(rank, keep_sorted.astype(jnp.float32)) > 0.5
    return mask & keep


def _epipolar_shift(state: StereoState, cfg: VOConfig):
    """Shift candidates onto the epipolar line
    (shift_Edge_to_Epipolar_Line, Stereo_Matches.cpp:26-89)."""
    line = state.epi_line[:, None, :]
    xy = jnp.stack([state.cx, state.cy], axis=-1)
    foot, nd = geom.normal_foot_on_line(line, xy)
    inter1, disp1 = geom.tangential_intersection_with_line(
        line, xy, state.ctheta)
    # orientation perturbation branch
    a, b = line[..., 0], line[..., 1]
    p_th = a * jnp.cos(state.ctheta) + b * jnp.sin(state.ctheta)
    dp_th = -a * jnp.sin(state.ctheta) + b * jnp.cos(state.ctheta)
    dtheta = jnp.where(dp_th > 0, cfg.orient_perturbation,
                       jnp.where(dp_th < 0, -cfg.orient_perturbation, 0.0))
    theta2 = state.ctheta + dtheta
    inter2, disp2 = geom.tangential_intersection_with_line(line, xy, theta2)

    case_a = nd < cfg.location_perturbation
    case_b = ~case_a & (disp1 < cfg.epip_tangency_displ_thresh)
    case_c = (~case_a & ~case_b
              & (disp2 < cfg.epip_tangency_displ_thresh))

    new_xy = jnp.where(case_a[..., None], foot,
                       jnp.where(case_b[..., None], inter1,
                                 jnp.where(case_c[..., None], inter2, xy)))
    new_theta = jnp.where(case_c, theta2, state.ctheta)
    return state._replace(cx=new_xy[..., 0], cy=new_xy[..., 1],
                          ctheta=new_theta)


def _flatten_active(cmask, max_pairs: int):
    """Compact active (row, slot) pairs to a flat list.
    Returns (rows, slots, fmask) each (max_pairs,)."""
    N, C = cmask.shape
    flat = cmask.reshape(-1)
    pos = SF.cumsum_i32(flat) - 1
    lin = jnp.arange(N * C, dtype=jnp.int32)
    # distinct OOB targets for dropped entries: unique_indices=True is a
    # promise, and a duplicated (even dropped) index is undefined
    # behaviour on every backend. Inactive targets start at N*C (not
    # max_pairs): active overflow positions pos in [max_pairs, N*C) would
    # collide with max_pairs+lin whenever actives exceed capacity, which
    # the KITTI-resolution workload can do at smaller budgets.
    tgt = jnp.where(flat, pos, N * C + lin)
    slot_of = jnp.zeros((max_pairs,), jnp.int32).at[tgt].set(
        lin, mode="drop", unique_indices=True)
    n_active = jnp.minimum(pos[-1] + 1, max_pairs)
    fmask = jnp.arange(max_pairs, dtype=jnp.int32) < n_active
    rows = slot_of // C
    slots = slot_of % C
    return rows, slots, fmask


def _scatter_back(template, rows, slots, fmask, values):
    """Scatter flat values back into an (N, C) tensor."""
    N, C = template.shape
    lin = rows * C + slots
    # distinct OOB targets (see _flatten_active)
    lin = jnp.where(fmask, lin,
                    N * C + jnp.arange(lin.shape[0], dtype=jnp.int32))
    flatt = template.reshape(-1)
    out = flatt.at[lin].set(values, mode="drop", unique_indices=True)
    return out.reshape(N, C)


def derive_gather_band(rig, cfg: VOConfig) -> float:
    """Vertical half-height (px) of the stage-1 candidate gather window,
    derived from the rig's epipolar geometry (host-side, static).

    The reference scans ALL right edges in its epipolar filter
    (Stereo_Matches.cpp:381-419) and so has no blind spot. Our banded grid
    query needs a static vertical bound on the displacement u = q - p of a
    valid candidate q from the left edge p. q satisfies
    |dist(q, line(p))| <= eps and |u| <= D (the stage-2 gate uses the
    Euclidean distance, Stereo_Matches.cpp:534-553). Writing
    delta(p) = dist(p, line(p)) (zero for rectified rigs, large for verged
    ones - p itself need not sit on its own epipolar line), the feasible u
    lies on the strip {n . u = -delta +- eps} within the disk, so
      |u_y| <= delta |n_y| + sqrt(D^2 - delta^2) |t_y| + eps,
    with (n, t) the line's unit normal/direction. Maximized over a host
    grid of image points. Rectified rigs evaluate to the old 4.0 band;
    verged rigs (e.g. EuRoC's real extrinsics) widen so sloped/offset
    epipolar geometry keeps full recall.

    rig: config.StereoRig (host).
    """
    import numpy as np

    F = np.asarray(rig.F21, np.float64)
    W, H = rig.left.width, rig.left.height
    D = float(cfg.max_disparity)
    eps = float(cfg.epipolar_line_dist_thresh)
    xs = np.linspace(0.0, W - 1.0, 32)
    ys = np.linspace(0.0, H - 1.0, 32)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], -1)
    lines = pts @ F.T                       # right-image lines (a, b, c)
    a, b, c = lines[:, 0], lines[:, 1], lines[:, 2]
    norm = np.hypot(a, b)
    ok = norm > 1e-12
    a, b, c = a[ok], b[ok], c[ok]
    norm = norm[ok]
    ny = np.abs(b) / norm                   # unit normal y-component
    ty = np.abs(a) / norm                   # unit direction y-component
    delta = np.abs(a * pts[ok, 0] + b * pts[ok, 1] + c) / norm
    delta = np.minimum(delta, D)            # beyond D: no candidates at all
    # chord half-length at the NEAR edge of the strip (|n.u| >= delta-eps):
    # sqrt(D^2 - delta^2) alone is not an upper bound near delta ~= D,
    # where sqrt(D^2 - (delta-eps)^2) ~= sqrt(2 D eps) can exceed the
    # +eps+1 slack (e.g. ~5 px at D=25, eps=0.5)
    d_near = np.maximum(delta - eps, 0.0)
    dy = delta * ny + np.sqrt(np.maximum(D * D - d_near * d_near, 0.0)) * ty
    ry = (float(dy.max()) if dy.size else 0.0) + eps + 1.0
    return float(max(4.0, min(ry, H / 2.0)))


def match_stereo(left_edges: EdgeList, right_edges: EdgeList,
                 frame: FrameData, rig: RigArrays, cfg: VOConfig,
                 disparity_map: Optional[jnp.ndarray] = None,
                 occlusion_map: Optional[jnp.ndarray] = None,
                 gather_ry: float = 4.0,
                 record_distributions: bool = False):
    """Run the full stereo cascade.

    `occlusion_map`: optional ETH3D non-occlusion mask (255 = visible in
    both views, Dataset.cpp:226). When given alongside `disparity_map`,
    edges whose GT location is occluded are excluded from the veridical
    supervision sets (the reference loads these masks but its in-pipeline
    use is commented out, Pipeline.cpp:71-72; threading them into the GT
    path removes false "missed match" penalties at occlusions).

    Returns (StereoMates, StereoState, metrics) where metrics is a
    (n_stages, 4) array row-indexed by STAGE_NAMES: with GT,
    [recall, precision, precision_pair, ambiguity] per stage; without GT,
    [rows with >=1 candidate, total candidates, 0, 0] survival diagnostics.

    `record_distributions`: also return a 4th element - a dict of raw
    filter-score / ambiguity distributions (the reference's
    RECORD_FILTER_DISTRIBUTIONS surface, Stereo_Matches.cpp:421-489):
    '<filter>' -> (values (N,C), is_gt (N,C), mask (N,C)) at the stage
    where that filter is evaluated (pre-gate), and '<stage>_ambiguity'
    -> (counts (N,), row_mask (N,)). Written to the reference's text
    formats by utils/debug_io.write_filter_distribution.
    """
    has_gt = disparity_map is not None
    N = cfg.max_edges
    C = cfg.max_candidates
    H, W = frame.left.shape

    lx, ly, lt = left_edges.x, left_edges.y, left_edges.theta
    row_mask = left_edges.valid
    epi = geom.epipolar_lines(rig.F21, jnp.stack([lx, ly], -1))

    # ---- GT supervision path (Find_Stereo_GT_Locations, ref :133-200) ----
    if has_gt:
        disp, disp_ok = P.bilinear_sample_nan(disparity_map, lx, ly)
        deg = geom.rad2deg(lt)
        orient_excl = ((jnp.abs(deg) < cfg.gt_orient_exclusion_deg)
                       | (jnp.abs(deg - 180.0) < cfg.gt_orient_exclusion_deg)
                       | (jnp.abs(deg + 180.0) < cfg.gt_orient_exclusion_deg))
        gt_ok = disp_ok & jnp.isfinite(disp) & (disp >= 0) & ~orient_excl
        if occlusion_map is not None:
            # bilinear >= 254 == all 4 neighbor pixels are 255 (visible);
            # conservative at occlusion boundaries
            occ, occ_in = P.bilinear_sample_nan(occlusion_map, lx, ly)
            gt_ok = gt_ok & occ_in & (occ >= 254.0)
        gt_x = jnp.where(gt_ok, lx - disp, -1.0)
        gt_y = jnp.where(gt_ok, ly, -1.0)
        ray1 = geom.pixel_to_ray(rig.K_left_inv, jnp.stack([lx, ly], -1))
        ray2 = geom.pixel_to_ray(rig.K_left_inv, jnp.stack([gt_x, gt_y], -1))
        gamma_l = geom.backproject_two_rays(rig.R21, rig.T21, ray1, ray2)
        gamma_r = jnp.einsum("ij,nj->ni", rig.R21, gamma_l) + rig.T21
        row_mask = row_mask & gt_ok
    else:
        gt_x = jnp.full((N,), -1.0, jnp.float32)
        gt_y = jnp.full((N,), -1.0, jnp.float32)
        gamma_l = jnp.full((N, 3), -1.0, jnp.float32)
        gamma_r = jnp.full((N, 3), -1.0, jnp.float32)

    # ---- right-edge spatial index (attrs packed so queries fetch rows,
    # not per-attribute element gathers) ----
    r_attrs = jnp.stack([right_edges.x, right_edges.y, right_edges.theta], -1)
    rgrid = GRID.build_sorted_grid(right_edges.x, right_edges.y,
                                   right_edges.valid, W, H, band_h=8,
                                   attrs=r_attrs)

    # ---- veridical sets (get_Stereo_Edge_GT_Pairs, ref :202-268) ----
    if has_gt:
        vidx, v_attrs, vmask = GRID.query_sorted_grid_attrs(
            rgrid, gt_x, gt_y, rx=cfg.gt_pair_dist_tol + 0.5,
            ry=cfg.gt_pair_dist_tol + 0.5, slots_per_band=16, n_band_window=2)
        v_x = v_attrs[0]
        v_y = v_attrs[1]
        v_t = v_attrs[2]
        v_epi = geom.point_line_distance(epi[:, None, :],
                                         jnp.stack([v_x, v_y], -1))
        v_d = jnp.sqrt((v_x - gt_x[:, None]) ** 2 + (v_y - gt_y[:, None]) ** 2)
        # raw (unwrapped) orientation difference, ref :124
        v_dth = jnp.abs(geom.rad2deg(v_t) - geom.rad2deg(lt)[:, None])
        vmask = (vmask & (v_epi < cfg.epipolar_line_dist_thresh)
                 & (v_d < cfg.gt_pair_dist_tol)
                 & (v_dth < cfg.gt_pair_orient_tol))
        row_mask = row_mask & jnp.any(vmask, axis=1)

    # ---- stages 1-3 on the raw gather window, THEN compact to C.
    # The cheap geometric gates run on all `gather_slots` so the capacity
    # truncation only happens after the orientation stage, where measured
    # ambiguity is small (reference has no capacity at all - its candidate
    # vectors shrink via erase; SURVEY.md §7 hard-part #2). ----
    # gather window sized from epipolar geometry (derive_gather_band):
    # 4.0 px / 2 bands for rectified rigs, wider for verged ones
    n_band_window = int(-(-2.0 * gather_ry // 8)) + 1
    gidx, g_attrs, gmask = GRID.query_sorted_grid_attrs(
        rgrid, lx, ly, rx=cfg.max_disparity + 1.5, ry=gather_ry,
        slots_per_band=max(8, cfg.gather_slots // n_band_window),
        n_band_window=n_band_window)
    g_x = g_attrs[0]
    g_y = g_attrs[1]
    g_t = g_attrs[2]

    metrics = []

    def _count_row(mask):
        """Production-mode stage diagnostics: [rows with >=1 candidate,
        total candidates, 0, 0] - free (computed on-device with the rest
        of the program) and makes silent cascade collapse visible."""
        return jnp.stack([jnp.sum(jnp.any(mask, 1)).astype(jnp.float32),
                          jnp.sum(mask).astype(jnp.float32),
                          jnp.float32(0.0), jnp.float32(0.0)])

    def record_raw(mask):
        if not has_gt:
            metrics.append(_count_row(mask))
            return
        d = jnp.sqrt((g_x - gt_x[:, None]) ** 2 + (g_y - gt_y[:, None]) ** 2)
        tp = mask & (d <= cfg.dist_to_gt_thresh)
        n_tp = jnp.sum(tp, 1)
        n_c = jnp.sum(mask, 1)
        has_c = row_mask & (n_c > 0)
        rows = jnp.maximum(jnp.sum(row_mask), 1)
        rows_w = jnp.maximum(jnp.sum(has_c), 1)
        prec = jnp.where(n_c > 0, n_tp / jnp.maximum(n_c, 1), 0.0)
        metrics.append(jnp.stack([
            jnp.sum(row_mask & (n_tp > 0)) / rows,
            jnp.sum(jnp.where(row_mask, prec, 0.0)) / rows,
            jnp.sum(jnp.where(has_c, prec, 0.0)) / rows_w,
            jnp.sum(jnp.where(has_c, n_c, 0)) / rows_w]))

    # stage 1: epipolar line distance (ref :381-419)
    g_epi = geom.point_line_distance(epi[:, None, :],
                                     jnp.stack([g_x, g_y], -1))
    gmask = gmask & (g_epi < cfg.epipolar_line_dist_thresh) & row_mask[:, None]
    record_raw(gmask)

    # stage 2: max disparity (ref :534-553)
    g_d = jnp.sqrt((g_x - lx[:, None]) ** 2 + (g_y - ly[:, None]) ** 2)
    gmask = gmask & (g_d <= cfg.max_disparity)
    record_raw(gmask)

    # stage 3: orientation (ref :863-915)
    g_dth = geom.orientation_diff_deg(lt[:, None], g_t)
    gmask = gmask & geom.orientation_gate(g_dth, cfg.orientation_thresh_deg)
    record_raw(gmask)

    cand_idx, c_attrs, cmask = GRID.compact_candidates_attrs(
        gidx, g_attrs, gmask, C, priority=g_epi)
    state = StereoState(
        row_mask=row_mask, lx=lx, ly=ly, ltheta=lt, epi_line=epi,
        gt_x=gt_x, gt_y=gt_y, gamma_gt_l=gamma_l, gamma_gt_r=gamma_r,
        cand_idx=cand_idx,
        cx=c_attrs[0], cy=c_attrs[1],
        ctheta=c_attrs[2], cmask=cmask,
        ncc=jnp.zeros((N, C), jnp.float32),
        desc_dist=jnp.full((N, C), 2.0 * cfg.sift_threshold, jnp.float32),
    )

    def record(st):
        metrics.append(_metrics(st, cfg.dist_to_gt_thresh) if has_gt
                       else _count_row(st.cmask))

    dists = {}

    def _cand_is_gt(st):
        if not has_gt:
            return jnp.zeros_like(st.cmask)
        d = jnp.sqrt((st.cx - st.gt_x[:, None]) ** 2
                     + (st.cy - st.gt_y[:, None]) ** 2)
        return st.cmask & (d <= cfg.dist_to_gt_thresh)

    def snap_filter(name, st, values):
        """Pre-gate filter scores + veridical flags
        (record_Filter_Distribution, Stereo_Matches.cpp:421-452)."""
        if record_distributions:
            dists[name] = (values, _cand_is_gt(st), st.cmask)

    def snap_ambiguity(stage, st):
        """Per-edge candidate counts (record_Ambiguity_Distribution,
        Stereo_Matches.cpp:454-489)."""
        if record_distributions:
            dists[f"{stage}_ambiguity"] = (jnp.sum(st.cmask, axis=1),
                                           st.row_mask)

    def snap_state(stage, st):
        """Full cascade-state snapshot at a stage, feeding the reference's
        per-cluster evaluation writers (io.h:14-160: photo-refine eval,
        matching-cluster transitions, false-negative clusters)."""
        if record_distributions:
            dists[f"{stage}_state"] = st

    # Chunk skipping: TOED edge lists and the flat pair lists are
    # compacted with actives packed first, so chunks past the real count
    # are skipped entirely (ops/tiled_sampling.py map_chunked).

    # ---- descriptors for all edges (augment_Edge_Data, ref :655-689) ----
    l_desc = DESC.edge_descriptors_tiled(
        frame.left_gx, frame.left_gy, lx, ly, lt,
        shift_mag=cfg.sift_shift_mag, n_samples=cfg.desc_patch_samples,
        n_spatial=cfg.desc_spatial_bins, n_orient=cfg.desc_orient_bins,
        spacing=cfg.desc_sample_spacing, clip=cfg.desc_clip,
        scale=cfg.desc_scale, chunk=cfg.sample_chunk,
        active=left_edges.valid)
    r_desc = DESC.edge_descriptors_tiled(
        frame.right_gx, frame.right_gy, right_edges.x, right_edges.y,
        right_edges.theta,
        shift_mag=cfg.sift_shift_mag, n_samples=cfg.desc_patch_samples,
        n_spatial=cfg.desc_spatial_bins, n_orient=cfg.desc_orient_bins,
        spacing=cfg.desc_sample_spacing, clip=cfg.desc_clip,
        scale=cfg.desc_scale, chunk=cfg.sample_chunk,
        active=right_edges.valid)

    # ---- stage 4: descriptor gate (ref :691-787). Two layouts:
    #   "dense" (default): the row-chunked (N, C) formulation.
    #   "flat": post-orientation ambiguity averages ~11 of C=32 slots at
    #     KITTI resolution, so dense (N, C) work is ~3x padding. Compact
    #     active (row, slot) pairs to a flat list (as the GN stage does);
    #     cost scales with measured pairs, chunk skipping frees the
    #     budget tail.
    # Results are identical for live slots under both layouts; which is
    # faster on a GPU is not measured yet. ----
    from edge_based_visual_odometry_tpu.ops import tiled_sampling as TS

    if record_distributions:
        dists["right_edges_xyt"] = (right_edges.x, right_edges.y,
                                    right_edges.theta)

    flat_gates = cfg.gate_layout in ("flat", "flat4")
    flat_gates_ncc = cfg.gate_layout in ("flat", "flat5")
    gate_budget = min(cfg.max_gate_pairs, N * C)
    if flat_gates:
        rows4, slots4, fmask4 = _flatten_active(state.cmask, gate_budget)
        ridx4 = state.cand_idx[rows4, slots4]

        def _desc_chunk(args):
            rows_c, ridx_c = args
            d = DESC.min_cross_distance_dot(l_desc[rows_c],
                                            r_desc[ridx_c][:, None])
            return d[:, 0]

        ddist_flat = TS.map_chunked(_desc_chunk, (rows4, ridx4),
                                    gate_budget, cfg.gate_chunk,
                                    active=fmask4)
        # Template value = just-passing: slots NOT in the flat list are
        # either cmask=False (the AND below keeps them dead regardless) or
        # ACTIVE pairs beyond the gate_budget overflow - those must remain
        # alive unscored (the dense layout scores everything), not be
        # silently killed; at threshold level they still lose BNB against
        # well-scored siblings.
        ddist = _scatter_back(jnp.full((N, C),
                                       cfg.sift_threshold * (1.0 - 1e-6),
                                       jnp.float32),
                              rows4, slots4, fmask4, ddist_flat)
    else:
        def _desc_chunk_dense(args):
            idx_c, ld_c = args
            return DESC.min_cross_distance_dot(ld_c, r_desc[idx_c])

        ddist = TS.map_chunked(_desc_chunk_dense, (state.cand_idx, l_desc),
                               N, cfg.sample_chunk,
                               active=jnp.any(state.cmask, axis=1))
    snap_filter("sift_distance", state, ddist)
    state = state._replace(
        cmask=state.cmask & (ddist < cfg.sift_threshold),
        desc_dist=ddist)
    record(state)
    snap_ambiguity("sift", state)

    # ---- patches for NCC (get_edge_patches, utility.cpp:182-212) ----
    # Patches are stored FLAT (N, 2*P*P) = [plus | minus]: one contiguous
    # 98-wide row per edge, so each downstream per-candidate gather moves
    # one row instead of two short ones (and no tiled layout pads a
    # size-2 minor dimension).
    pp_n = cfg.patch_size * cfg.patch_size
    lp_p, lp_m, lok_p, lok_m = P.edge_patches_tiled(
        frame.left, lx, ly, lt, cfg.patch_size, cfg.orthogonal_shift_mag,
        chunk=cfg.sample_chunk, active=left_edges.valid)
    l_patches = jnp.concatenate([lp_p, lp_m], axis=-1)  # (N, 2*P*P)
    l_patch_ok = jnp.stack([lok_p, lok_m], axis=1)
    rp_p, rp_m, rok_p, rok_m = P.edge_patches_tiled(
        frame.right, right_edges.x, right_edges.y, right_edges.theta,
        cfg.patch_size, cfg.orthogonal_shift_mag, chunk=cfg.sample_chunk,
        active=right_edges.valid)
    r_patches = jnp.concatenate([rp_p, rp_m], axis=-1)
    r_patch_ok = jnp.stack([rok_p, rok_m], axis=1)

    # ---- stage 5: NCC (ref :555-616), same two layouts as stage 4;
    # the flat list is re-flattened so the SIFT gate's kills are excluded
    # from the work ----
    if flat_gates_ncc:
        rows5, slots5, fmask5 = _flatten_active(state.cmask, gate_budget)
        ridx5 = state.cand_idx[rows5, slots5]

        def _ncc_chunk(args):
            rows_c, ridx_c = args
            lp_c = l_patches[rows_c]                   # (b, 2*P*P)
            lok_c = l_patch_ok[rows_c]
            cp = r_patches[ridx_c]
            cok = r_patch_ok[ridx_c]
            return P.ncc4(lp_c[:, :pp_n], lp_c[:, pp_n:],
                          lok_c[:, 0], lok_c[:, 1],
                          cp[:, :pp_n], cp[:, pp_n:],
                          cok[:, 0], cok[:, 1])

        sim_flat = TS.map_chunked(_ncc_chunk, (rows5, ridx5),
                                  gate_budget, cfg.gate_chunk,
                                  active=fmask5)
        # just-passing template for budget-overflow actives (see stage 4)
        sim = _scatter_back(jnp.full((N, C), cfg.ncc_thresh + 1e-6,
                                     jnp.float32),
                            rows5, slots5, fmask5, sim_flat)
    else:
        def _ncc_chunk_dense(args):
            idx_c, lp_c, lok_c = args
            cp = r_patches[idx_c]                      # (b, C, 2*P*P)
            cok = r_patch_ok[idx_c]
            return P.ncc4(lp_c[:, None, :pp_n], lp_c[:, None, pp_n:],
                          lok_c[:, None, 0], lok_c[:, None, 1],
                          cp[:, :, :pp_n], cp[:, :, pp_n:],
                          cok[:, :, 0], cok[:, :, 1])

        sim = TS.map_chunked(_ncc_chunk_dense,
                             (state.cand_idx, l_patches, l_patch_ok),
                             N, cfg.sample_chunk,
                             active=jnp.any(state.cmask, axis=1))
    snap_filter("ncc", state, sim)
    state = state._replace(cmask=state.cmask & (sim > cfg.ncc_thresh),
                           ncc=sim)
    record(state)

    # ---- stage 6/7: best-nearly-best (ref :789-862) ----
    state = state._replace(cmask=_bnb_keep(
        state.ncc, state.cmask, cfg.bnb_ncc, higher_better=True))
    record(state)
    state = state._replace(cmask=_bnb_keep(
        state.desc_dist, state.cmask, cfg.bnb_sift, higher_better=False))
    record(state)

    # ---- stage 8: epipolar shift (ref :967-1008, consolidate shift) ----
    state = _epipolar_shift(state, cfg)
    snap_state("shift", state)

    # ---- stage 9: photometric GN along epipolar (ref :1159-1358) ----
    rows, slots, fmask = _flatten_active(state.cmask, cfg.max_refine_pairs)
    epi_dir = jnp.stack([-state.epi_line[:, 1], state.epi_line[:, 0]], -1)
    epi_dir = epi_dir / jnp.linalg.norm(epi_dir, axis=-1, keepdims=True)
    # pack the per-row and per-slot operands so the flat list is fetched
    # with TWO row gathers instead of six narrow 131072-element ones
    row_pack = jnp.stack([state.lx, state.ly, state.ltheta,
                          epi_dir[:, 0], epi_dir[:, 1]], -1)[rows]
    cand_pack = jnp.stack([state.cx, state.cy],
                          -1).reshape(N * C, 2)[rows * C + slots]
    res = GN.refine_along_epipolar_batch(
        frame.left, frame.right, frame.right_gx, frame.right_gy,
        row_pack[:, 0], row_pack[:, 1], row_pack[:, 2],
        cand_pack[:, 0], cand_pack[:, 1], row_pack[:, 3:5],
        patch_size=cfg.patch_size, max_iter=cfg.gn_max_iter,
        tol=cfg.gn_tol, huber_delta=cfg.huber_delta,
        tile=cfg.gn_tile, chunk=cfg.gn_chunk, active=fmask,
        phase1_iters=cfg.gn_phase1_iters,
        phase2_budget=cfg.gn_phase2_budget,
        phase1_chunk=cfg.gn_phase1_chunk,
        weight_split=cfg.gn_weight_split)
    # NOTE: the shift applies UNCONDITIONALLY - reference parity. The
    # stereo driver updates every cluster center with the refined alpha
    # and stores refined_validity only for evaluation statistics
    # (refine_edge_disparity, Stereo_Matches.cpp:1340-1352; validities
    # consumed only at :315-320). The TEMPORAL driver, by contrast, gates
    # the update per side (Temporal_Matches.cpp:622-631) and
    # temporal_matcher.py mirrors that.
    shift_x = res.delta * row_pack[:, 3]
    shift_y = res.delta * row_pack[:, 4]
    state = state._replace(
        cx=_scatter_back(state.cx, rows, slots, fmask,
                         cand_pack[:, 0] + shift_x),
        cy=_scatter_back(state.cy, rows, slots, fmask,
                         cand_pack[:, 1] + shift_y),
        ncc=_scatter_back(state.ncc, rows, slots, fmask, res.score),
        desc_dist=_scatter_back(state.desc_dist, rows, slots, fmask,
                                res.confidence))
    record(state)
    snap_ambiguity("photometric_refinement", state)
    snap_state("photo_refine", state)

    # ---- stage 10: clustering (ref :1483 -> EdgeClusterer; stereo path
    #      clusters WITHOUT the orientation gate, EdgeClusterer ctor arg
    #      b_cluster_by_orientation = b_do_epipolar_shift = false) ----
    cl = CL.cluster_edges(state.cx, state.cy, state.ctheta, state.cmask,
                          dist_thresh=cfg.cluster_dist_thresh,
                          orient_thresh_deg=cfg.cluster_orient_thresh,
                          by_orientation=False,
                          gauss_sigma=cfg.cluster_orient_gauss_sigma,
                          max_cluster_size=cfg.max_cluster_size)
    state = state._replace(cx=jnp.where(cl.mask, cl.x, state.cx),
                           cy=jnp.where(cl.mask, cl.y, state.cy),
                           ctheta=jnp.where(cl.mask, cl.theta, state.ctheta),
                           cmask=cl.mask)
    record(state)
    snap_ambiguity("edge_clustering", state)
    snap_state("cluster", state)

    # ---- stage 11: post-cluster NCC at new centers (ref :1500) ----
    rows, slots, fmask = _flatten_active(state.cmask, cfg.max_refine_pairs)
    f_pack = jnp.stack([state.cx, state.cy, state.ctheta],
                       -1).reshape(N * C, 3)[rows * C + slots]
    fx = f_pack[:, 0]
    fy = f_pack[:, 1]
    ft = f_pack[:, 2]
    pp, pm, okp, okm = P.edge_patches_tiled(
        frame.right, fx, fy, ft, cfg.patch_size, cfg.orthogonal_shift_mag,
        chunk=cfg.sample_chunk, active=fmask)
    lp_r = l_patches[rows]
    sim_f = P.ncc4(lp_r[:, :pp_n], lp_r[:, pp_n:],
                   l_patch_ok[rows, 0], l_patch_ok[rows, 1],
                   pp, pm, okp, okm)
    # just-passing template: active pairs beyond the flat budget stay
    # alive unscored rather than being killed by the -1 default (same
    # rule as the stage-4/5 gates); threshold-level scores still lose
    # the stage-12 argmax to any real scored sibling
    sim_full = _scatter_back(jnp.full_like(state.ncc, cfg.ncc_thresh + 1e-6),
                             rows, slots, fmask, sim_f)
    state = state._replace(
        cmask=state.cmask & (sim_full > cfg.ncc_thresh), ncc=sim_full)
    record(state)

    # ---- stage 12: best-only pick (apply_Lowe_Ratio_Test, ref :916-965) ----
    best_slot = jnp.argmax(jnp.where(state.cmask, state.ncc, -jnp.inf), axis=1)
    only_best = (jax.lax.broadcasted_iota(jnp.int32, (N, C), 1)
                 == best_slot[:, None])
    state = state._replace(cmask=state.cmask & only_best)
    record(state)

    # ---- cleanup (remove_empty_clusters, ref :1543-1576) ----
    state = state._replace(row_mask=state.row_mask & jnp.any(state.cmask, 1))
    record(state)

    # ---- finalize (finalize_stereo_edge_mates, ref :1578-1653) ----
    mates = _finalize(state, frame, rig, cfg, l_patches, l_patch_ok, l_desc,
                      best_slot)
    if record_distributions:
        return mates, state, jnp.stack(metrics), dists
    return mates, state, jnp.stack(metrics)


def _finalize(state: StereoState, frame: FrameData, rig: RigArrays,
              cfg: VOConfig, l_patches, l_patch_ok, l_desc, best_slot):
    N = cfg.max_edges
    M = cfg.max_mates
    alive = state.row_mask
    pos = SF.cumsum_i32(alive) - 1
    # distinct OOB targets (see _flatten_active): inactive targets start
    # at N (not M) - alive rows can exceed M (measured 24k mates vs
    # max_mates), and pos >= M would collide with M + i
    tgt = jnp.where(alive, pos, N + jnp.arange(N, dtype=jnp.int32))
    count = jnp.minimum(pos[-1] + 1, M).astype(jnp.int32)
    row_of = jnp.zeros((M,), jnp.int32).at[tgt].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop", unique_indices=True)
    valid = jnp.arange(M, dtype=jnp.int32) < count

    bs = best_slot[row_of]
    rx = state.cx[row_of, bs]
    ry = state.cy[row_of, bs]
    rt = state.ctheta[row_of, bs]
    lx = state.lx[row_of]
    ly = state.ly[row_of]
    lt = state.ltheta[row_of]

    # right patches at final positions (ref :1622)
    pp, pm, okp, okm = P.edge_patches_tiled(
        frame.right, rx, ry, rt, cfg.patch_size, cfg.orthogonal_shift_mag,
        chunk=cfg.sample_chunk, active=valid)
    r_patches = jnp.concatenate([pp, pm], axis=-1)     # flat [plus|minus]
    r_patch_ok = jnp.stack([okp, okm], axis=1)

    # right descriptors at final positions (ref :1627-1635)
    r_desc = DESC.edge_descriptors_tiled(
        frame.right_gx, frame.right_gy, rx, ry, rt,
        shift_mag=cfg.sift_shift_mag, n_samples=cfg.desc_patch_samples,
        n_spatial=cfg.desc_spatial_bins, n_orient=cfg.desc_orient_bins,
        spacing=cfg.desc_sample_spacing, clip=cfg.desc_clip,
        scale=cfg.desc_scale, chunk=cfg.sample_chunk, active=valid)

    # production 3D point: two-ray backprojection of the matched pair
    # (the pose stage re-derives exactly this, MotionTracker.cpp:34-47)
    ray1 = geom.pixel_to_ray(rig.K_left_inv, jnp.stack([lx, ly], -1))
    ray2 = geom.pixel_to_ray(rig.K_right_inv, jnp.stack([rx, ry], -1))
    gamma = geom.backproject_two_rays(rig.R21, rig.T21, ray1, ray2)

    gt_x = state.gt_x[row_of]
    gt_y = state.gt_y[row_of]
    d_gt = jnp.sqrt((rx - gt_x) ** 2 + (ry - gt_y) ** 2)
    is_tp = valid & (gt_x >= 0) & (d_gt <= cfg.dist_to_gt_thresh)

    z = lambda a: jnp.where(valid, a, 0.0)
    return StereoMates(
        left_x=z(lx), left_y=z(ly), left_theta=z(lt),
        right_x=z(rx), right_y=z(ry), right_theta=z(rt),
        # patches stay f32: bf16 storage would halve the temporal NCC
        # gather bytes but add an upcast per gather; not measured on a
        # GPU yet
        left_patches=l_patches[row_of] * valid[:, None],
        right_patches=r_patches * valid[:, None],
        left_patch_ok=l_patch_ok[row_of] & valid[:, None],
        right_patch_ok=r_patch_ok & valid[:, None],
        left_desc=l_desc[row_of] * valid[:, None],
        right_desc=r_desc * valid[:, None],
        gamma=gamma * valid[:, None],
        gamma_gt=state.gamma_gt_l[row_of] * valid[:, None],
        gt_x=jnp.where(valid, gt_x, -1.0), gt_y=jnp.where(valid, gt_y, -1.0),
        is_tp=is_tp, valid=valid, count=count,
    )
