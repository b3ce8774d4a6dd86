#!/usr/bin/env python
"""CLI entry point: YAML-config-driven stereo edge VO.

Equivalent of the reference's cmd/main_VO.cpp:22-119: parses
--config_file, loads the YAML dataset description (same schema as
config/kitti.yaml etc.), builds the dataset iterator and pipeline, and
drives the frame loop. Unlike the reference (which hard-caps at 2 frames,
cmd/main_VO.cpp:111-112), --max_frames defaults to the whole sequence.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="Edge-based stereo VO")
    ap.add_argument("-c", "--config_file", required=True,
                    help="YAML config (reference schema, config/*.yaml)")
    ap.add_argument("--max_frames", type=int, default=0,
                    help="process at most N frames (0 = all)")
    ap.add_argument("--use_gt_pose", action="store_true",
                    help="eval mode: build quads from GT relative pose "
                         "(the reference's veridical path)")
    ap.add_argument("--output_dir", default=None,
                    help="override output_dir from the YAML")
    ap.add_argument("--max_edges", type=int, default=None)
    ap.add_argument("--no_prefetch", action="store_true",
                    help="disable the native background decode threads")
    ap.add_argument("--dump_stereo_pairs", action="store_true",
                    help="write finalized_stereo_edge_pairs_frame_N.txt per "
                         "frame (reference Stereo_Matches.cpp:1656-1699)")
    ap.add_argument("--dump_quads", action="store_true",
                    help="write quads_frame_N.txt per re-keyframing frame "
                         "(reference Temporal_Matches.cpp:1066-1112)")
    ap.add_argument("--record_filter_distributions", action="store_true",
                    help="write per-frame filter-score + ambiguity "
                         "distribution files (reference "
                         "RECORD_FILTER_DISTRIBUTIONS, definitions.h:61)")
    ap.add_argument("--save_viz", action="store_true",
                    help="after the run, render every recognized dump in the "
                         "output dir to PNG figures under <output_dir>/viz "
                         "(offline analysis suite, viz/; replaces the "
                         "reference's MATLAB scripts)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save/resume pipeline state here (new capability; "
                         "utils/checkpoint.py). An existing checkpoint is "
                         "resumed automatically; already-processed frames "
                         "are skipped.")
    ap.add_argument("--checkpoint_every", type=int, default=25,
                    help="checkpoint cadence in frames (with "
                         "--checkpoint_dir)")
    ap.add_argument("--keyframe_policy", default="every_frame",
                    choices=["reference", "every_frame", "adaptive"],
                    help="keyframe selection: 'reference' = frame 0 "
                         "forever (reference src/Pipeline.cpp:133-137), "
                         "'every_frame' = frame-to-frame VO, 'adaptive' = "
                         "re-keyframe when tracking quality drops")
    ap.add_argument("--ba_window", type=int, default=0,
                    help="sliding-window BA length in keyframes (0 = off; "
                         "new capability, models/window_ba.py)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override any VOConfig field (repeatable), e.g. "
                         "--set gn_max_iter=10 --set ncc_thresh=0.5. The "
                         "reference needs a rebuild for the same change "
                         "(include/definitions.h).")
    args = ap.parse_args(argv)
    if args.ba_window >= 2 and args.keyframe_policy == "reference":
        # fail at the CLI boundary, not as a VOPipeline ValueError
        # traceback deep in __post_init__
        ap.error("--ba_window >= 2 requires a re-keyframing policy "
                 "(--keyframe_policy every_frame|adaptive): windowed BA "
                 "chains tracks across keyframes, and 'reference' never "
                 "creates a second keyframe")

    try:
        import yaml
    except ImportError as e:
        raise SystemExit("main_vo.py reads its dataset description with "
                         "PyYAML; install the 'pyyaml' package") from e
    with open(args.config_file) as f:
        cfg_yaml = yaml.safe_load(f)

    from edge_based_visual_odometry_tpu import VOConfig
    from edge_based_visual_odometry_tpu.config import rig_from_yaml_dict
    from edge_based_visual_odometry_tpu.geometry import Pose
    from edge_based_visual_odometry_tpu.io import datasets
    from edge_based_visual_odometry_tpu.models import pipeline as PL
    from edge_based_visual_odometry_tpu.models import stereo_matcher as SM
    from edge_based_visual_odometry_tpu.models import temporal_matcher as TM
    from edge_based_visual_odometry_tpu.utils import metrics as MET
    import jax.numpy as jnp

    rig = rig_from_yaml_dict(cfg_yaml)
    dataset_type = cfg_yaml["dataset_type"]
    has_gt_disparity = dataset_type == "ETH3D_stereo"  # src/Dataset.cpp:126-129

    import dataclasses

    vo_cfg = VOConfig()
    if args.max_edges:
        # scale the dependent fixed-shape capacities with the edge budget
        n = args.max_edges
        # keep the same capacity ratios as the defaults (sized for
        # max_edges=32768 from the measured sweep; see VOConfig)
        vo_cfg = dataclasses.replace(
            vo_cfg, max_edges=n,
            max_mates=max(256, vo_cfg.max_mates * n // VOConfig.max_edges),
            max_refine_pairs=max(1024, vo_cfg.max_refine_pairs * n
                                 // VOConfig.max_edges),
            # gate/pose flat budgets scale with the edge budget too, else
            # raising --max_edges silently overflows the default
            # capacities (defaults are sized for max_edges=32768)
            max_gate_pairs=max(4096,
                               vo_cfg.max_gate_pairs * n
                               // VOConfig.max_edges),
            max_pose_quads=max(512,
                               vo_cfg.max_pose_quads * n
                               // VOConfig.max_edges),
            ransac_max_iterations=min(vo_cfg.ransac_max_iterations,
                                      max(512, n // 4)))
    for kv in args.set:
        key, _, val = kv.partition("=")
        cur = getattr(vo_cfg, key)     # AttributeError on unknown field
        if isinstance(cur, bool):
            parsed = val.lower() in ("1", "true", "yes")
        else:
            parsed = type(cur)(val)
        vo_cfg = dataclasses.replace(vo_cfg, **{key: parsed})

    out_dir = args.output_dir or cfg_yaml.get("output_dir", "./outputs")
    os.makedirs(out_dir, exist_ok=True)

    pipe = PL.VOPipeline(rig=rig, cfg=vo_cfg,
                         has_gt_disparity=has_gt_disparity,
                         use_gt_pose=args.use_gt_pose,
                         keyframe_policy=args.keyframe_policy,
                         ba_window=args.ba_window,
                         record_distributions=args.record_filter_distributions)
    rig_arrays = None
    if (args.dump_stereo_pairs or args.dump_quads
            or args.record_filter_distributions):
        from edge_based_visual_odometry_tpu.models.types import RigArrays
        from edge_based_visual_odometry_tpu.utils import debug_io as DIO
        rig_arrays = RigArrays.from_rig(rig)

    resume_from = 0
    file_pos = 0           # dataset FILE-list position to resume decode at
    restored_gt = None
    if args.checkpoint_dir:
        from edge_based_visual_odometry_tpu.utils import checkpoint as CKPT
        if CKPT.restore_pipeline_state(args.checkpoint_dir, pipe):
            resume_from = pipe.frame_idx
            # file position + GT trajectory travel alongside the pipeline
            # checkpoint: decode failures make file position != frame
            # count, and rebuilding gt_traj from the metadata prefix
            # would re-include the never-processed bad files
            cs_path = os.path.join(args.checkpoint_dir, "cli_state.npz")
            legacy_resume = not os.path.exists(cs_path)
            if not legacy_resume:
                cs = np.load(cs_path)
                file_pos = int(cs["file_pos"])
                restored_gt = [Pose(jnp.asarray(R), jnp.asarray(t))
                               for R, t in zip(cs["gt_R"], cs["gt_t"])]
            else:
                # Legacy checkpoint (no cli_state.npz): the file position
                # is unknown, so fall back to the pre-file_idx behavior -
                # decode everything (start=0) and skip the first
                # `resume_from` successfully-decoded samples. Equating
                # file_pos with resume_from instead would re-run the last
                # frame whenever decode failures preceded the checkpoint.
                file_pos = 0
            print(f"resumed from checkpoint at frame {resume_from} "
                  f"(file {'unknown - legacy checkpoint' if legacy_resume else file_pos})",
                  flush=True)

    # file_pos makes the iterator skip image decode for the files the
    # restored trajectory already covers (metadata still yielded)
    it = datasets.make_iterator(
        dataset_type, cfg_yaml["dataset_dir"], cfg_yaml["sequence_name"],
        cfg_yaml.get("gt_file_path", ""),
        np.asarray(rig.rot_frame2body) if rig.rot_frame2body else None,
        np.asarray(rig.transl_frame2body) if rig.transl_frame2body else None,
        image_hw=(rig.left.height, rig.left.width),
        prefetch=not args.no_prefetch, start=file_pos)

    gt_traj = list(restored_gt) if restored_gt is not None else []
    timestamps = []
    t0 = time.time()
    n = resume_from
    last_file_pos = file_pos
    n_yielded = 0

    def save_ckpt():
        CKPT.save_pipeline_state(args.checkpoint_dir, pipe)
        gtR = (np.stack([np.asarray(p.R) for p in gt_traj])
               if gt_traj else np.zeros((0, 3, 3), np.float32))
        gtt = (np.stack([np.asarray(p.t) for p in gt_traj])
               if gt_traj else np.zeros((0, 3), np.float32))
        np.savez(os.path.join(args.checkpoint_dir, "cli_state.npz"),
                 file_pos=last_file_pos, gt_R=gtR, gt_t=gtt)

    for sample in it:
        n_yielded += 1
        skip = (n_yielded <= resume_from if restored_gt is None
                else sample.file_idx < file_pos)
        if skip:
            # already in the restored trajectory
            timestamps.append(sample.timestamp)
            last_file_pos = max(last_file_pos, sample.file_idx + 1)
            if restored_gt is None and sample.gt_R is not None:
                # legacy checkpoints only: rebuild GT from the skipped
                # prefix (decoded samples, so bad files are excluded)
                R_wc = sample.gt_R.T
                t_wc = -sample.gt_R.T @ sample.gt_t
                gt_traj.append(Pose(jnp.asarray(R_wc, jnp.float32),
                                    jnp.asarray(t_wc, jnp.float32)))
            continue
        gt_pose = None
        if sample.gt_R is not None:
            # dataset GT is camera-to-world; pipeline uses world-to-camera
            R_wc = sample.gt_R.T
            t_wc = -sample.gt_R.T @ sample.gt_t
            gt_pose = Pose(jnp.asarray(R_wc, jnp.float32),
                           jnp.asarray(t_wc, jnp.float32))
            gt_traj.append(gt_pose)
        timestamps.append(sample.timestamp)
        kf_before = pipe.keyframe   # quads in tr reference THIS keyframe
        kf_idx_before = pipe.kf_index
        fr, tr = pipe.run_frame(sample.left, sample.right,
                                disparity=sample.left_disparity,
                                gt_pose=gt_pose,
                                occlusion=sample.left_occlusion)
        if args.dump_stereo_pairs:
            DIO.write_finalized_stereo_pairs(
                os.path.join(out_dir,
                             f"finalized_stereo_edge_pairs_frame_{n}.txt"),
                fr.mates, rig_arrays)
        if args.dump_quads and tr is not None and kf_before is not None:
            DIO.write_quads(os.path.join(out_dir, f"quads_frame_{n}.txt"),
                            kf_before.mates, tr.quads,
                            kf_idx=kf_idx_before, cf_idx=n)
        if args.record_filter_distributions:
            DIO.write_distributions(out_dir, n, fr.distributions)
            if has_gt_disparity:
                # io.h per-cluster evaluation dumps (photo-refine eval,
                # TP->FN transitions, false-negative clusters)
                DIO.write_eval_cluster_dumps(out_dir, n, fr.distributions,
                                             tol=vo_cfg.gt_pair_dist_tol)
        n += 1
        last_file_pos = sample.file_idx + 1
        msg = (f"frame {n - 1}: edges L/R = {int(fr.n_left_edges)}/"
               f"{int(fr.n_right_edges)}, mates = {int(fr.mates.count)}")
        if tr is not None:
            msg += (f", quads = {int(tr.n_quads)}, "
                    f"inliers = {int(tr.inlier_count)} "
                    f"({float(tr.inlier_ratio):.3f})")
        print(msg, flush=True)
        if (args.checkpoint_dir and args.checkpoint_every
                and n % args.checkpoint_every == 0):
            save_ckpt()
        if args.max_frames and n >= args.max_frames:
            break

    if args.checkpoint_dir and n > resume_from:
        save_ckpt()

    dt = time.time() - t0
    done = n - resume_from
    print(f"\nprocessed {n} frames in {dt:.2f}s "
          f"({max(done, 0) / dt:.3f} frames/s)")

    if pipe.stereo_metrics_log:
        avg = MET.average_stage_metrics(pipe.stereo_metrics_log)
        print(MET.format_stage_table(SM.STAGE_NAMES, avg,
                                     "Stereo Edge Matching Metrics"))
    if pipe.temporal_metrics_log:
        avg = MET.average_stage_metrics(pipe.temporal_metrics_log)
        print(MET.format_stage_table(TM.TEMPORAL_STAGE_NAMES, avg,
                                     "Temporal Quad Matching Metrics"))

    traj_file = os.path.join(out_dir, "trajectory_tum.txt")
    # real sample timestamps so TUM tooling (evo, associate.py) can match
    # against groundtruth files; fall back to frame indices on length
    # mismatch (e.g. resumed runs over datasets with decode failures)
    ts = timestamps if len(timestamps) == len(pipe.trajectory) else None
    MET.write_trajectory_tum(traj_file, pipe.trajectory, timestamps=ts)
    print(f"trajectory written to {traj_file}")

    if gt_traj and len(gt_traj) == len(pipe.trajectory):
        ate = MET.ate_rmse(pipe.trajectory, gt_traj)
        rpe_t, rpe_r = MET.rpe_stats(pipe.trajectory, gt_traj)
        print(f"ATE RMSE = {ate:.4f} m | RPE = {rpe_t:.4f} m, {rpe_r:.4f} deg")
        rec = {"ate_rmse": ate, "rpe_trans": rpe_t,
               "rpe_rot_deg": rpe_r, "frames": n,
               "frames_processed": max(done, 0),
               # resumed (skipped) frames must not inflate fps
               "frames_per_s": max(done, 0) / dt}
        if pipe.ba_info_log:
            # windowed-BA cost split: host bookkeeping vs device solve
            import numpy as _np
            rec["ba"] = {
                "solves": len(pipe.ba_info_log),
                "mean_landmarks": float(_np.mean(
                    [b["n_landmarks"] for b in pipe.ba_info_log])),
                "mean_obs": float(_np.mean(
                    [b["n_obs"] for b in pipe.ba_info_log])),
                "mean_host_assembly_s": float(_np.mean(
                    [b["host_assembly_s"] for b in pipe.ba_info_log])),
                "mean_solve_s": float(_np.mean(
                    [b["solve_s"] for b in pipe.ba_info_log])),
            }
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(rec, f, indent=2)

    if args.save_viz:
        from edge_based_visual_odometry_tpu.viz.__main__ import _render_all
        _render_all(out_dir, os.path.join(out_dir, "viz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
