#!/usr/bin/env python
"""Long-sequence production-resolution validation.

The closest achievable stand-in for a KITTI-00 ATE gate (no real dataset
can be fetched): a >=100-frame synthetic corridor at
376x1241 with realistic forward motion (make_corridor_sequence), driven
through the PRODUCTION CLI path (adaptive keyframing + sliding-window
BA, no GT supervision), then judged on:

  - ATE RMSE under a drift bound,
  - no capacity-guard trips (mates/quads never collapse),
  - every frame produces a pose (no identity fallbacks).

The reference caps its driver at 2 frames (cmd/main_VO.cpp:111-112);
this exercises 50x that at full production resolution.

Usage (on the GPU; on the CPU with --backend cpu, ~1-2 h):
    python scripts/long_seq_validation.py [--n_frames 100] [--out DIR]
Writes <out>/metrics.json + longseq_result.json (the judged record).
"""

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_tree(root: str, n_frames: int, h: int, w: int):
    import numpy as np
    import yaml
    from PIL import Image

    from edge_based_visual_odometry_tpu.io import synthetic as S

    seq_dir = os.path.join(root, "KITTI-gray", "00")
    os.makedirs(os.path.join(seq_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "image_1"), exist_ok=True)
    gt_dir = os.path.join(root, "KITTI-gt", "poses")
    os.makedirs(gt_dir, exist_ok=True)

    seq = S.make_corridor_sequence(n_frames=n_frames, h=h, w=w)
    gt_lines = []
    for k, f in enumerate(seq.frames):
        Image.fromarray(f.left.astype(np.uint8)).save(
            os.path.join(seq_dir, "image_0", f"{k:06d}.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(
            os.path.join(seq_dir, "image_1", f"{k:06d}.png"))
        Rcw = f.R.T
        tcw = -f.R.T @ f.t
        M = np.hstack([Rcw, tcw[:, None]])
        gt_lines.append(" ".join(f"{v:.9f}" for v in M.reshape(-1)))
    with open(os.path.join(gt_dir, "00.txt"), "w") as fo:
        fo.write("\n".join(gt_lines) + "\n")

    K = seq.rig.left.K
    cfg = {
        "dataset_type": "KITTI",
        "dataset_dir": root,
        "sequence_name": "KITTI-gray/00",
        "output_dir": os.path.join(root, "out"),
        "gt_file_path": "KITTI-gt/poses",
        "left_camera": {"resolution": [w, h],
                        "intrinsics": [float(K[0, 0]), float(K[1, 1]),
                                       float(K[0, 2]), float(K[1, 2])],
                        "distortion_coefficients": [0, 0, 0, 0]},
        "right_camera": {"resolution": [w, h],
                         "intrinsics": [float(K[0, 0]), float(K[1, 1]),
                                        float(K[0, 2]), float(K[1, 2])],
                         "distortion_coefficients": [0, 0, 0, 0]},
        "stereo": {"R21": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.0, 0.0, 1.0]],
                   "T21": [float(seq.rig.T21[0]), 0.0, 0.0]},
    }
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as fo:
        yaml.safe_dump(cfg, fo)
    # total GT path length for a drift-relative bound
    import numpy as np
    cs = [-f.R.T @ f.t for f in seq.frames]
    path_len = float(sum(np.linalg.norm(cs[i + 1] - cs[i])
                         for i in range(len(cs) - 1)))
    return cfg_path, path_len


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_frames", type=int, default=100)
    ap.add_argument("--h", type=int, default=376)
    ap.add_argument("--w", type=int, default=1241)
    ap.add_argument("--out", default=os.path.join(
        REPO, "outputs", "longseq_376x1241"))
    ap.add_argument("--backend", default=None, choices=["cpu"])
    ap.add_argument("--ba_window", type=int, default=5)
    ap.add_argument("--drift_frac", type=float, default=0.05,
                    help="ATE bound as a fraction of GT path length")
    args = ap.parse_args()

    print(f"rendering {args.n_frames} corridor frames at "
          f"{args.h}x{args.w} ...", flush=True)
    cfg_path, path_len = build_tree(args.out, args.n_frames, args.h,
                                    args.w)
    env = dict(os.environ)
    if args.backend:
        env["JAX_PLATFORMS"] = args.backend
    out_dir = os.path.join(args.out, "out")
    cmd = [sys.executable, os.path.join(REPO, "main_vo.py"),
           "-c", cfg_path, "--keyframe_policy", "adaptive",
           "--ba_window", str(args.ba_window),
           "--output_dir", out_dir]
    print("running:", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=14400,
                       env=env)
    sys.stdout.write(r.stdout[-4000:])
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        return 1

    # capacity-guard scan: any collapsed frame invalidates the run
    # (thresholds scale down for small smoke-test resolutions)
    min_mates, min_quads = (1000, 500) if args.h * args.w > 300000 \
        else (100, 50)
    bad = []
    for m in re.finditer(r"frame (\d+): edges L/R = (\d+)/(\d+), "
                         r"mates = (\d+)(?:, quads = (\d+), "
                         r"inliers = (\d+))?", r.stdout):
        fi, el, er, mates = (int(m.group(i)) for i in range(1, 5))
        quads = int(m.group(5)) if m.group(5) else None
        if mates < min_mates or (quads is not None and quads < min_quads):
            bad.append((fi, mates, quads))

    # metrics.json may be absent (GT trajectory missing/length-mismatched,
    # e.g. a frame produced no pose): emit a judged pass:false record
    # instead of an unhandled FileNotFoundError traceback
    try:
        metrics = json.load(open(os.path.join(out_dir, "metrics.json")))
    except (FileNotFoundError, json.JSONDecodeError) as e:
        print(f"metrics.json unavailable: {e}", file=sys.stderr)
        metrics = {"ate_rmse": None, "rpe_trans": None,
                   "rpe_rot_deg": None, "frames_per_s": None}
    ate = metrics["ate_rmse"]
    bound = args.drift_frac * path_len
    result = {
        "n_frames": args.n_frames,
        "resolution": [args.h, args.w],
        "backend": args.backend or "default",
        "ba_window": args.ba_window,
        "keyframe_policy": "adaptive",
        # record the judging criterion INSIDE the result so a loosened
        # bound is visible without recomputing ate_bound/gt_path_len
        "drift_frac": args.drift_frac,
        "gt_path_len_m": round(path_len, 3),
        "ate_rmse_m": ate,
        "ate_bound_m": round(bound, 3),
        "rpe_trans_m": metrics["rpe_trans"],
        "rpe_rot_deg": metrics["rpe_rot_deg"],
        "frames_per_s": metrics["frames_per_s"],
        "ba": metrics.get("ba"),
        "collapsed_frames": bad,
        "pass": bool(ate is not None and ate < bound and not bad),
    }
    rec_path = os.path.join(REPO, "benchmarks", "longseq_result.json")
    with open(rec_path, "w") as fo:
        json.dump(result, fo, indent=2)
    print(json.dumps(result, indent=2))
    print(f"recorded to {rec_path}")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    main()
