#!/usr/bin/env python
"""CPU-vs-accelerator cascade parity check: the silent-miscompile detector.

A backend compiler can break one stage of the stereo cascade while the CPU
results stay correct (a constant-folded epipolar gate, a mis-fused
descriptor gate): every CPU test still passes, and only a CPU-vs-device
diff of the per-stage survival counts shows the damage.

This script runs a synthetic frame pair through the FULL stereo +
temporal steps on both backends and diffs the per-stage counts and final
outputs, in one of two configurations:

  small (default): 240x320, reduced budgets - fast smoke parity.
  --prod: 376x1241 (KITTI resolution), UNMODIFIED VOConfig defaults, the
     exact bench.py synthetic frames. Some collapses appear only where
     the capacities bind, which they never do at 240x320.

Usage (from the repo root, on a host with a GPU):
    python scripts/check_parity.py [--prod] [--layout=flat|dense|...]

Each backend runs in its own child process (JAX_PLATFORMS=cpu / gpu), so
the parent never opens the card. Exit code 0 = backends agree;
1 = divergence (prints the first stage that differs).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def collect(prod: bool = False, layout: str = None) -> dict:
    """Run the parity workload on this process's default backend and
    return its per-stage counts and final outputs."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from edge_based_visual_odometry_tpu.config import VOConfig
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    if prod:
        # the bench.py workload: KITTI resolution, UNMODIFIED defaults
        seq = S.make_sequence(n_frames=2, h=376, w=1241)
        cfg = VOConfig()
    else:
        seq = S.make_sequence(n_frames=2, h=240, w=320)
        cfg = dataclasses.replace(
            VOConfig(), max_edges=8192, max_mates=4096,
            max_refine_pairs=16384, max_gate_pairs=65536,
            max_pose_quads=4096)
    if layout:
        cfg = dataclasses.replace(cfg, gate_layout=layout)
    sstep = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
    tstep = PL.build_temporal_step(seq.rig, cfg, use_gt=False)
    kf = sstep(jnp.asarray(seq.frames[0].left),
               jnp.asarray(seq.frames[0].right))
    cf = sstep(jnp.asarray(seq.frames[1].left),
               jnp.asarray(seq.frames[1].right))
    I = jnp.eye(3, dtype=jnp.float32)
    z = jnp.zeros((3,), jnp.float32)
    # bootstrap-then-predict (see bench.py): the diffed temporal counts
    # come from the steady-state prediction-centered workload. Both legs
    # feed the prediction from their own bootstrap estimate; pose
    # agreement is part of what parity checks, and a diverged boot pose
    # would surface as (intended) count divergence downstream.
    tr_b = tstep(kf.mates, kf.frame, cf.mates, cf.frame, I, z, jnp.int32(0))
    tr = tstep(kf.mates, kf.frame, cf.mates, cf.frame, tr_b.R, tr_b.t,
               jnp.int32(0))
    n = int(kf.mates.count)
    lx = np.asarray(kf.mates.left_x)[:n]
    return {
        "backend": jax.devices()[0].platform,
        "edges": [int(kf.n_left_edges), int(kf.n_right_edges)],
        "stereo_pairs": [int(r[1]) for r in np.asarray(kf.stereo_metrics)],
        "temporal_pairs": [int(r[1])
                           for r in np.asarray(tr.temporal_metrics)],
        "mates": n,
        "quads": int(tr.n_quads),
        "inlier_ratio": round(float(tr.inlier_ratio), 4),
        "mate_x_sum": round(float(lx.sum()), 1),
    }


def run_child(platform: str, prod: bool = False, layout: str = None,
              timeout: float = 5400) -> dict:
    """collect() in a child process pinned to `platform` by JAX_PLATFORMS,
    so that it never opens a device the caller holds."""
    env = dict(os.environ, JAX_PLATFORMS=platform)
    args = [sys.executable, os.path.abspath(__file__), "--child"]
    if prod:
        args.append("--prod")
    if layout:
        args.append(f"--layout={layout}")
    out = subprocess.run(args, env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{platform} child failed:\n{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def diff(ref: dict, dev: dict) -> bool:
    """True when the device leg `dev` agrees with the reference leg `ref`
    (the CPU): edges within 0.2%, mates and quads within 3%, each stage
    count within 5% + 5. A collapse to zero on both legs is a failure of
    the workload, reported as such."""
    rn, dn = ref.get("backend", "ref"), dev.get("backend", "dev")
    print(f"{rn}:", json.dumps(ref))
    print(f"{dn}:", json.dumps(dev))
    ok = True
    # a == b must count as equal BEFORE any ratio test: min > r*max is
    # False at (0, 0), which would misreport a symmetric collapse on BOTH
    # backends as a backend divergence. Flag both-zero separately as a
    # workload collapse.
    for key in ("mates", "quads"):
        if ref[key] == 0 and dev[key] == 0:
            print(f"WORKLOAD COLLAPSED on both backends at {key} "
                  "(not a backend divergence)")
            ok = False
    for key in ("edges", "mates", "quads"):
        a, b = ref[key], dev[key]
        if key == "edges":
            # f32 NMS threshold ties flip O(1) edges between backends at
            # production shapes; require a tight ratio, not equality
            same = all(x == y or min(x, y) > 0.998 * max(x, y)
                       for x, y in zip(a, b))
        else:
            same = a == b or min(a, b) > 0.97 * max(a, b)
        if not same:
            print(f"DIVERGENCE at {key}: {rn}={a} {dn}={b}")
            ok = False
    for key in ("stereo_pairs", "temporal_pairs"):
        for i, (a, b) in enumerate(zip(ref[key], dev[key])):
            if min(a, b) < 0.95 * max(a, b) - 5:
                print(f"DIVERGENCE at {key}[{i}]: {rn}={a} {dn}={b}")
                ok = False
                break
    return ok


def _layout_arg(argv):
    for a in argv:
        if a.startswith("--layout="):
            return a.split("=", 1)[1]
    return None


def main(argv) -> int:
    prod = "--prod" in argv
    layout = _layout_arg(argv)
    label = "prod 376x1241/full-defaults" if prod else "small 240x320"
    print(f"configuration: {label}, layout={layout or 'default'}")
    cpu = run_child("cpu", prod, layout)
    gpu = run_child("gpu", prod, layout)
    ok = diff(cpu, gpu)
    print("PARITY OK" if ok else "PARITY FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.path.insert(0, REPO)
        print(json.dumps(collect("--prod" in sys.argv,
                                 _layout_arg(sys.argv))))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
