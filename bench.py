#!/usr/bin/env python
"""Headline benchmark: end-to-end VO frames/s on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "platform": ..., "device_kind": ..., "gpu_name": ..., "power_limit": ...}

Exits non-zero without a frame rate when JAX finds no GPU: a CPU rate is
not a measurement of this system.

Workload: the full production per-frame pipeline at KITTI resolution
(1241 x 376; config/kitti.yaml:13) on synthetic frames - TOED detection on
both images, the 11-stage stereo cascade, temporal quad matching against a
keyframe, and RANSAC pose. No GT supervision (production path).

Baseline: the reference publishes no numbers (BASELINE.md), so the
baseline is measured on this host by building and running the ACTUAL
reference binary (benchmarks/ref_build/build_reference.sh) on a
KITTI-resolution synthetic fixture: 209.4 s per production stereo frame
(2-frame minus 1-frame wall time; see BASELINE.md "measured whole-frame"
section). That frame does strictly LESS work than ours (the reference's
temporal stage degenerates without GT), so the reported speedup is an
UNDERestimate. Cached in benchmarks/ref_whole_frame_376x1241_secs.txt;
if absent, falls back to the TOED-only floor from
benchmarks/ref_toed_baseline.cpp (a further underestimate).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def whole_frame_baseline(h: int, w: int):
    """Seconds per frame of the actual reference binary at (h, w), if
    measured on this host (benchmarks/ref_build/, BASELINE.md)."""
    cache = os.path.join(REPO, "benchmarks",
                         f"ref_whole_frame_{h}x{w}_secs.txt")
    if os.path.exists(cache):
        return float(open(cache).read().split()[0])
    return None


def measure_cpu_baseline(h: int, w: int) -> float:
    """Seconds per image for the reference-equivalent CPU TOED."""
    cache = os.path.join(REPO, "benchmarks", f"baseline_{h}x{w}_secs.txt")
    if os.path.exists(cache):
        return float(open(cache).read().strip())
    exe = os.path.join(REPO, "benchmarks", "ref_toed_baseline")
    src = os.path.join(REPO, "benchmarks", "ref_toed_baseline.cpp")
    if not os.path.exists(exe):
        subprocess.run(["g++", "-O2", "-fopenmp", "-o", exe, src], check=True)
    out = subprocess.run([exe, str(h), str(w), "2"], capture_output=True,
                         text=True, check=True, timeout=1200)
    secs = float(out.stdout.strip())
    with open(cache, "w") as f:
        f.write(f"{secs}\n")
    return secs


def run_workload(seq, n_frames):
    """Warm up + guard + time the production steps. Returns
    (fps, workload_dict) on success or (None, error_str) if the workload
    guard trips. The workload dict records the starvation state (mates vs
    max_mates, pct_refined) and pose error vs the synthetic GT so the JSON
    is self-describing about workload integrity."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from edge_based_visual_odometry_tpu.config import VOConfig
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    cfg = VOConfig()
    stereo_step = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
    temporal_step = PL.build_temporal_step(seq.rig, cfg, use_gt=False)

    left0 = jnp.asarray(seq.frames[0].left)
    right0 = jnp.asarray(seq.frames[0].right)
    left1 = jnp.asarray(seq.frames[1].left)
    right1 = jnp.asarray(seq.frames[1].right)

    # warm-up / compile. Bootstrap like the production pipeline: the first
    # temporal call runs on the identity prediction (prediction-centered
    # gather sees only prediction error = the full motion there), then the
    # steady-state workload is measured with a REALISTIC prediction (the
    # bootstrap estimate; production uses the previous frame's velocity,
    # equivalent accuracy on this constant-velocity sequence).
    kf = jax.block_until_ready(stereo_step(left0, right0))
    cf = jax.block_until_ready(stereo_step(left1, right1))
    I = jnp.eye(3, dtype=jnp.float32)
    z = jnp.zeros((3,), jnp.float32)
    tr_boot = jax.block_until_ready(temporal_step(
        kf.mates, kf.frame, cf.mates, cf.frame, I, z, jnp.int32(42)))
    pred1 = (tr_boot.R, tr_boot.t)
    tr_f1 = tr = jax.block_until_ready(temporal_step(
        kf.mates, kf.frame, cf.mates, cf.frame, *pred1, jnp.int32(42)))

    # WORKLOAD GUARD: a backend miscompile once silently zeroed all
    # stereo matches, so the cascade ran empty and the "benchmark" timed a
    # near-empty program. Never report a number without proving the full
    # workload is loaded.
    n_mates = int(kf.mates.count)
    n_quads = int(tr.n_quads)
    if n_mates < 1000 or n_quads < 500:
        return None, (f"workload collapsed: mates={n_mates} quads={n_quads}"
                      " (miscompile guard)")

    # frame 2 makes up half the timed loop: guard its workload too (a
    # content-dependent collapse on one rendered frame would otherwise
    # inflate every other timed iteration)
    left2 = jnp.asarray(seq.frames[2].left)
    right2 = jnp.asarray(seq.frames[2].right)
    cf2 = jax.block_until_ready(stereo_step(left2, right2))
    tr2_boot = jax.block_until_ready(temporal_step(
        kf.mates, kf.frame, cf2.mates, cf2.frame, I, z, jnp.int32(43)))
    pred2 = (tr2_boot.R, tr2_boot.t)
    tr2 = jax.block_until_ready(temporal_step(
        kf.mates, kf.frame, cf2.mates, cf2.frame, *pred2, jnp.int32(43)))
    n_mates2 = int(cf2.mates.count)
    n_quads2 = int(tr2.n_quads)
    if n_mates2 < 1000 or n_quads2 < 500:
        return None, (f"frame-2 workload collapsed: mates={n_mates2} "
                      f"quads={n_quads2} (miscompile guard)")

    # timed loop: one full frame = stereo step + temporal/pose vs keyframe.
    # Content alternates between two distinct rendered frames so
    # content-dependent cliffs (edge counts, gather-slot pressure) are
    # inside the measurement, not hidden by repeating one pair.
    pairs = [(left1, right1, pred1), (left2, right2, pred2)]
    t0 = time.perf_counter()
    for k in range(n_frames):
        l, r, (pR, pt) = pairs[k % len(pairs)]
        cf = stereo_step(l, r)
        tr = temporal_step(kf.mates, kf.frame, cf.mates, cf.frame, pR, pt,
                           jnp.int32(k))
    jax.block_until_ready(tr)
    dt = time.perf_counter() - t0
    fps = n_frames / dt

    def pose_err(tr_res, f_kf, f_cf):
        R_gt = np.asarray(f_cf.R) @ np.asarray(f_kf.R).T
        t_gt = np.asarray(f_cf.t) - R_gt @ np.asarray(f_kf.t)
        dR = np.asarray(tr_res.R) @ R_gt.T
        ang = float(np.degrees(np.arccos(
            np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        return [round(ang, 4),
                round(float(np.linalg.norm(np.asarray(tr_res.t) - t_gt)), 4)]

    sm = np.asarray(kf.stereo_metrics)
    gn_input = int(sm[6, 1])            # BNB-SIFT survivors = GN input
    workload = {
        "mates": n_mates, "max_mates": int(cfg.max_mates),
        "gn_input_pairs": gn_input,
        "pct_refined": round(min(1.0, cfg.max_refine_pairs
                                 / max(gn_input, 1)), 3),
        "quads": n_quads,
        # tr_f1/tr2 are the deterministic warm-up results (seeds 42/43),
        # not the timed loop's last iteration
        "inlier_ratio": round(float(tr_f1.inlier_ratio), 3),
        "pose_err_f1_deg_m": pose_err(tr_f1, seq.frames[0], seq.frames[1]),
        "pose_err_f2_deg_m": pose_err(tr2, seq.frames[0], seq.frames[2]),
    }
    return fps, workload


def main():
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.utils import device as DEV

    try:
        device = DEV.require_gpu()
    except DEV.NoGPUError as e:
        print(f"bench.py needs a GPU: {e}", file=sys.stderr)
        return 2

    H, W = 376, 1241            # KITTI grayscale resolution
    n_frames = 12

    seq = S.make_sequence(n_frames=3, h=H, w=W)
    fps, info = run_workload(seq, n_frames)
    if fps is None:
        print(json.dumps({
            "metric": "kitti_res_frames_per_s_single_chip",
            "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
            "error": info, **device}))
        return 1

    ref_frame_secs = whole_frame_baseline(H, W)
    if ref_frame_secs is not None:
        baseline_fps = 1.0 / ref_frame_secs
    else:
        baseline_secs_per_img = measure_cpu_baseline(H, W)
        baseline_fps = 1.0 / (2.0 * baseline_secs_per_img)  # 2 images/frame

    result = {
        "metric": "kitti_res_frames_per_s_single_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        # the reference targets Brown's HPC nodes (reference
        # CMakeLists.txt:124-175); its baseline here was measured on a
        # 4-core host, so vs_baseline overstates the gap vs the
        # reference's intended hardware - scale by its core count
        "baseline_hw": "reference binary, 4-core host CPU (OpenMP)",
        "workload": info,
        **device,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
