#!/usr/bin/env python
"""Capacity-starvation sweep at KITTI resolution.

The reference keeps EVERY mate/candidate in dynamically-sized vectors
(reference include/Dataset.h:180-289) and photometrically refines every
candidate (reference src/Stereo_Matches.cpp:1290-1358). Our fixed-shape
capacities bind at KITTI scale when they are set low (~24k final mates,
~91k GN inputs per frame). This sweep measures what each capacity point
costs - frames/s AND workload quality - so the defaults can be chosen
from data.

Each point reports: frames/s, mates (vs cap), GN-input pairs (vs budget,
= % refined), quads, inlier count/ratio.

Run on an otherwise-idle GPU:
    python benchmarks/capacity_sweep.py [--points NAME ...]
Results are appended to benchmarks/capacity_sweep_results.jsonl.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

POINTS = {
    # name -> VOConfig overrides (on top of defaults). The temporal
    # gather/patch buffers scale with max_mates, so the mate points are
    # also memory points.
    "default": {},
    "pose32k": {"max_pose_quads": 32768},
    "quads48": {"max_quad_candidates": 48},
    "refine128k": {"max_refine_pairs": 131072,
                   "gn_phase2_budget": 32768},
    "mates16k": {"max_mates": 16384},
    "mates24k": {"max_mates": 24576},
    "combo16k": {"max_mates": 16384, "max_refine_pairs": 131072,
                 "gn_phase2_budget": 32768, "max_quad_candidates": 48,
                 "max_pose_quads": 32768},
    # reference keep-everything semantics (mates < cap, 100% refined)
    # + the quad/pose capacities combo16k showed win on pose error.
    "combo24k": {"max_mates": 24576, "max_refine_pairs": 131072,
                 "gn_phase2_budget": 32768, "max_quad_candidates": 48,
                 "max_pose_quads": 32768},
    # Cq right-sizing under the prediction-centered gather (radius 16):
    # ambiguity within the tight window is ~4x lower than the reference
    # radius 30 the Cq=48 default was sized for.
    "cq24": {"max_quad_candidates": 24},
    "cq32": {"max_quad_candidates": 32},
    # tighter still: radius 12, slots 144
    "r12": {"temporal_grid_radius_prod": 12.0, "quad_gather_slots_prod": 144},
    # GN phase tuning at the keep-everything budgets
    "p1_2": {"gn_phase1_iters": 2},
    "p2_16k": {"gn_phase2_budget": 16384},
    "p1_2_p2_16k": {"gn_phase1_iters": 2, "gn_phase2_budget": 16384},
    # headroom arm: does the never-truncate max_mates == max_edges
    # capacity (mates <= left edge count) cost acceptable temporal-step
    # time?
    "mates32k": {"max_mates": 32768},
    # GN tile arm: T=40 -> 32 cuts the sampling einsum's T*U
    # contraction 0.64x but shrinks the GN travel bound from +-5.2 to
    # +-2.2 px (quality-gated: watch pose errors + inlier ratio)
    "tile32": {"gn_tile": 32},
    # flat temporal NCC/desc gates (work scales with occupancy)
    "tflat": {"temporal_gate_layout": "flat"},
    # split-weight bf16 GN value sampling (quality-gated: on the
    # FLOAT synthetic bench frames this also rounds tiles to bf16, a
    # harder test than the integer-valued production PNG path)
    "wsplit": {"gn_weight_split": True},
    # stereo flat gates (gate_layout A/B; the workload guards catch a
    # miscompile, scripts/check_parity.py --layout=flat confirms)
    "sflat": {"gate_layout": "flat"},
    # chunk re-tunes
    "sc1024": {"sample_chunk": 1024},
    "gc1024": {"gn_chunk": 1024},
    # combination candidates
    "r5combo": {"gn_phase1_iters": 2, "gn_phase2_budget": 16384,
                "gn_tile": 32},
    "r5combo_flat": {"gn_phase1_iters": 2, "gn_phase2_budget": 16384,
                     "gn_tile": 32, "temporal_gate_layout": "flat"},
}


def run_point(name: str, overrides: dict, n_frames: int = 8) -> dict:
    import jax
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.config import VOConfig
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    cfg = dataclasses.replace(VOConfig(), **overrides)
    seq = S.make_sequence(n_frames=3, h=376, w=1241)
    sstep = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
    tstep = PL.build_temporal_step(seq.rig, cfg, use_gt=False)

    I = jnp.eye(3, dtype=jnp.float32)
    z = jnp.zeros((3,), jnp.float32)
    frames = [(jnp.asarray(f.left), jnp.asarray(f.right))
              for f in seq.frames]
    # bootstrap-then-predict, mirroring the production pipeline and
    # bench.py: the identity-prediction call estimates the pose, the
    # measured workload runs with that realistic prediction
    kf = jax.block_until_ready(sstep(*frames[0]))
    cf = jax.block_until_ready(sstep(*frames[1]))
    tr_b = jax.block_until_ready(tstep(
        kf.mates, kf.frame, cf.mates, cf.frame, I, z, jnp.int32(42)))
    tr = jax.block_until_ready(tstep(
        kf.mates, kf.frame, cf.mates, cf.frame, tr_b.R, tr_b.t,
        jnp.int32(42)))
    cf2 = jax.block_until_ready(sstep(*frames[2]))
    tr2_b = jax.block_until_ready(tstep(
        kf.mates, kf.frame, cf2.mates, cf2.frame, I, z, jnp.int32(43)))
    tr2 = jax.block_until_ready(tstep(
        kf.mates, kf.frame, cf2.mates, cf2.frame, tr2_b.R, tr2_b.t,
        jnp.int32(43)))

    import numpy as np

    def pose_err(tr_res, f_kf, f_cf):
        """(rotation deg, translation m) error of the estimated KF->CF
        pose vs the synthetic GT."""
        R_gt = np.asarray(f_cf.R) @ np.asarray(f_kf.R).T
        t_gt = np.asarray(f_cf.t) - R_gt @ np.asarray(f_kf.t)
        R_e = np.asarray(tr_res.R)
        dR = R_e @ R_gt.T
        ang = float(np.degrees(np.arccos(
            np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        dt = float(np.linalg.norm(np.asarray(tr_res.t) - t_gt))
        return round(ang, 4), round(dt, 4)

    sm = np.asarray(kf.stereo_metrics)
    # stage rows: [.., BNB-SIFT(6)=GN input, .., Final(11)]
    gn_input = int(sm[6, 1])
    rec = {
        "point": name,
        "overrides": overrides,
        "edges": [int(kf.n_left_edges), int(kf.n_right_edges)],
        "gn_input_pairs": gn_input,
        "gn_budget": int(cfg.max_refine_pairs),
        "pct_refined": round(min(1.0, cfg.max_refine_pairs / max(gn_input, 1)), 3),
        "final_rows": int(sm[11, 1]),
        "mates": int(kf.mates.count),
        "max_mates": int(cfg.max_mates),
        "quads": int(tr.n_quads),
        "quads_f2": int(tr2.n_quads),
        "inlier_ratio": round(float(tr.inlier_ratio), 4),
        "inlier_ratio_f2": round(float(tr2.inlier_ratio), 4),
        "inlier_count": int(tr.inlier_count),
        "pose_err_f1": pose_err(tr, seq.frames[0], seq.frames[1]),
        "pose_err_f2": pose_err(tr2, seq.frames[0], seq.frames[2]),
    }
    if int(kf.mates.count) < 1000 or int(tr.n_quads) < 500:
        rec["error"] = "workload collapsed (miscompile guard)"
        return rec

    pairs = [(frames[1], (tr.R, tr.t)), (frames[2], (tr2.R, tr2.t))]
    t0 = time.perf_counter()
    for k in range(n_frames):
        (l, r), (pR, pt) = pairs[k % 2]
        cf = sstep(l, r)
        tr = tstep(kf.mates, kf.frame, cf.mates, cf.frame, pR, pt,
                   jnp.int32(k))
    jax.block_until_ready(tr)
    rec["frames_per_s"] = round(n_frames / (time.perf_counter() - t0), 3)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", nargs="*", default=list(POINTS))
    ap.add_argument("--n_frames", type=int, default=8)
    args = ap.parse_args()
    out_path = os.path.join(REPO, "benchmarks",
                            "capacity_sweep_results.jsonl")
    for name in args.points:
        rec = run_point(name, POINTS[name], args.n_frames)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
