#!/usr/bin/env python
"""GPU smoke run of the stereo edge-VO main path.

    python chip_smoke.py          # one GPU: phases 1-4 below
    python chip_smoke.py --four   # only the 4-GPU mesh paths vs one GPU

Phases, in order; the first one that fails ends the run with a non-zero
exit code and no result line:

  1. Device gate: the first JAX device must be a GPU (no CPU fallback).
     Prints the device kind and count, the JAX version and the card's
     name and power limit as nvidia-smi reports them.
  2. Production frame loop: VOPipeline driven as main_vo.py drives it, on
     an in-memory 8-frame 376x1241 synthetic corridor at the unmodified
     production VOConfig(), 'every_frame' keyframes and a 3-keyframe BA
     window. Checks finite poses, at least one BA solve, the bench.py
     workload guard and the per-frame relative-pose error against the
     synthetic ground truth. Prints compile walls, the stereo and temporal
     steps' memory analysis, peak device memory and warm per-frame walls.
  3. Parity with the plain references: TOED on the GPU against the
     float64 NumPy oracle (tests/toed_oracle.py) at 376x1241, and the
     full stereo + temporal steps on the GPU against the same steps on
     the CPU, both at 376x1241 with VOConfig() (scripts/check_parity.py
     --prod; the CPU leg runs in a child pinned to the CPU).
  4. XLA baselines: warm device time of the TOED gradient field at
     376x1241 and of the batched epipolar GN at 131,072 pairs.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Tolerances and precision. Every step runs with the package's global
"highest" matmul precision (full f32 on the GPU) except the sites that
name their own: the GN and descriptor tile sampling (TF32 / bf16 on the
tensor cores). Float scatter-adds (descriptor histograms, BA normal
equations) are atomics on the GPU, so their sums change from run to run
in the last bits; the count ratios below absorb that.
  - TOED vs oracle: f32 against f64. Gradient field rtol 2e-4, atol 2e-3;
    edge count within max(3, 1%); subpixel position within 0.05 px at the
    99th percentile; orientation within 1e-2 rad at the 98th percentile
    (the tolerances of tests/test_toed.py).
  - GPU vs CPU steps: both f32 under the same precision settings. Edges
    within 0.2%, mates and quads within 3%, each stage count within
    5% + 5 (check_parity.diff).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# Frame-loop workload guard (bench.py): a collapsed cascade must not pass
# as a fast one.
MIN_MATES = 1000
MIN_QUADS = 500
# Per-frame relative-pose error bound against the synthetic ground truth.
# The same phase run on the CPU backend (8 frames, seed 7, VOConfig(),
# on the GPU machine's host) measured at most 0.0154 deg and 1.48 mm; the
# bound is about 5x that, room for backend arithmetic (TF32 sampling,
# atomic scatter-adds) without admitting a broken pose.
MAX_ROT_DEG = 0.08
MAX_TRANS_M = 0.0075


class PhaseError(RuntimeError):
    """A phase's check failed."""


def device_gate(expect_count: int = 1):
    """Phase 1. Returns (device, card) or raises PhaseError."""
    import jax

    from edge_based_visual_odometry_tpu.utils import device as DEV

    try:
        ident = DEV.require_gpu(expect_count)
    except DEV.NoGPUError as e:
        raise PhaseError(f"no GPU: {e}; this smoke run needs one") from e
    card = f"{ident['gpu_name']}, {ident['power_limit']}"
    print(f"device: platform={ident['platform']} kind={ident['device_kind']}"
          f" count={ident['count']} jax={jax.__version__}", flush=True)
    print(f"card: {card}", flush=True)
    return jax.devices()[0], card


class CompileLog:
    """Sums XLA compile time and persistent-cache hits/misses while
    active."""

    # XLA's compile (or persistent-cache read) of one program; the
    # tracing and lowering events nest for nested jits, so they are left
    # out
    _COMPILE = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.compile_s = 0.0
        self.hits = 0
        self.misses = 0

    def _dur(self, name, secs, **_):
        if name == self._COMPILE:
            self.compile_s += secs

    def _event(self, name, **_):
        if name == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif name == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def __enter__(self):
        import jax
        self.compile_s, self.hits, self.misses = 0.0, 0, 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._dur)
        jax.monitoring.unregister_event_listener(self._event)


def quantize(img):
    """Integer-valued float32, as the dataset decoder yields 8-bit PNGs."""
    import numpy as np
    return np.clip(np.round(img), 0.0, 255.0).astype(np.float32)


def rotation_deg(R) -> float:
    """Rotation angle of R in degrees, accurate near zero (arctan2 of the
    skew and symmetric parts, not arccos of the trace)."""
    import numpy as np

    R = np.asarray(R, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(s, (np.trace(R) - 1.0) / 2.0)))


def relative_pose_errors(traj, frames):
    """Per-frame (rotation deg, translation m) error of the estimated
    frame-to-frame motion against the ground truth, frames 1..n-1."""
    import numpy as np

    out = []
    for k in range(1, len(traj)):
        Ra, ta = np.asarray(traj[k - 1].R, np.float64), np.asarray(
            traj[k - 1].t, np.float64)
        Rb, tb = np.asarray(traj[k].R, np.float64), np.asarray(
            traj[k].t, np.float64)
        R_est = Rb @ Ra.T
        t_est = tb - R_est @ ta
        fa, fb = frames[k - 1], frames[k]
        R_gt = fb.R @ fa.R.T
        t_gt = fb.t - R_gt @ fa.t
        out.append((rotation_deg(R_est @ R_gt.T),
                    float(np.linalg.norm(t_est - t_gt))))
    return out


def frame_loop(cfg, h: int = 376, w: int = 1241, n_frames: int = 8,
               seed: int = 7, ba_window: int = 3, log=print) -> dict:
    """Phase 2: drive VOPipeline over an in-memory synthetic corridor the
    way main_vo.py drives it (every_frame keyframes, windowed BA), one
    frame at a time. Returns per-frame records, BA solves, pose errors,
    the pipeline and the sequence."""
    import jax
    import numpy as np

    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    seq = S.make_corridor_sequence(n_frames=n_frames, h=h, w=w, seed=seed)
    pipe = PL.VOPipeline(rig=seq.rig, cfg=cfg,
                         keyframe_policy="every_frame", ba_window=ba_window)
    clog = CompileLog()
    records = []
    for k, f in enumerate(seq.frames):
        n_ba = len(pipe.ba_info_log)
        with clog:
            t0 = time.perf_counter()
            fr, tr = pipe.run_frame(quantize(f.left), quantize(f.right))
            jax.block_until_ready((fr, tr, pipe.trajectory[-1]))
            wall = time.perf_counter() - t0
        rec = {"frame": k, "wall_s": wall, "compile_s": clog.compile_s,
               "cache_hits": clog.hits, "cache_misses": clog.misses,
               "edges": [int(fr.n_left_edges), int(fr.n_right_edges)],
               "mates": int(fr.mates.count),
               "quads": None if tr is None else int(tr.n_quads),
               "inlier_ratio": (None if tr is None
                                else float(tr.inlier_ratio)),
               "ba_solve_s": [b["solve_s"]
                              for b in pipe.ba_info_log[n_ba:]]}
        records.append(rec)
        log(f"frame {k}: wall {wall:.4f} s (XLA compile {clog.compile_s:.4f} s,"
            f" cache hits {clog.hits} misses {clog.misses}), edges "
            f"{rec['edges']}, mates {rec['mates']}, quads {rec['quads']}, "
            f"inlier ratio {rec['inlier_ratio']}, BA solves "
            f"{rec['ba_solve_s']}")
    poses_finite = all(np.isfinite(np.asarray(p.R)).all()
                       and np.isfinite(np.asarray(p.t)).all()
                       for p in pipe.trajectory)
    return {"records": records, "ba_solves": len(pipe.ba_info_log),
            "ba_info": pipe.ba_info_log, "poses_finite": poses_finite,
            "n_poses": len(pipe.trajectory),
            "pose_errors": relative_pose_errors(pipe.trajectory,
                                                seq.frames),
            "pipe": pipe, "seq": seq}


def check_frame_loop(res: dict, min_mates: int = MIN_MATES,
                     min_quads: int = MIN_QUADS,
                     max_rot_deg: float = MAX_ROT_DEG,
                     max_trans_m: float = MAX_TRANS_M) -> list:
    """Failures of a frame_loop result against the phase-2 checks."""
    fails = []
    n = len(res["records"])
    if res["n_poses"] != n or not res["poses_finite"]:
        fails.append(f"{res['n_poses']} poses for {n} frames, finite="
                     f"{res['poses_finite']}")
    if res["ba_solves"] < 1:
        fails.append("no windowed-BA solve ran")
    for r in res["records"]:
        if r["mates"] < min_mates:
            fails.append(f"frame {r['frame']}: mates {r['mates']} < "
                         f"{min_mates}")
        if r["frame"] > 0 and (r["quads"] or 0) < min_quads:
            fails.append(f"frame {r['frame']}: quads {r['quads']} < "
                         f"{min_quads}")
    for k, (rot, tr) in enumerate(res["pose_errors"], start=1):
        if not (rot < max_rot_deg and tr < max_trans_m):
            fails.append(f"frame {k}: pose error {rot:.4f} deg / "
                         f"{tr:.5f} m over {max_rot_deg} deg / "
                         f"{max_trans_m} m")
    return fails


def _mib(nbytes) -> float:
    return nbytes / 2.0**20


def memory_report(pipe, card: str, log=print):
    """AOT-compile the pipeline's stereo and temporal steps (a persistent
    cache hit after the loop) and print XLA's memory analysis."""
    import jax
    import jax.numpy as jnp

    kf = pipe.keyframe
    left = jax.ShapeDtypeStruct(kf.frame.left.shape, jnp.float32)
    sp, tp = pipe._stereo_step, pipe._temporal_step
    progs = {
        "stereo": lambda: sp.func.lower(left, left, **sp.keywords),
        "temporal": lambda: tp.func.lower(
            kf.mates, kf.frame, kf.mates, kf.frame,
            jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.int32(0), **tp.keywords),
    }
    for name, lower in progs.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        log(f"[{card}] {name} step memory_analysis: argument "
            f"{_mib(ma.argument_size_in_bytes):.1f} MiB, output "
            f"{_mib(ma.output_size_in_bytes):.1f} MiB, temp "
            f"{_mib(ma.temp_size_in_bytes):.1f} MiB, generated code "
            f"{_mib(ma.generated_code_size_in_bytes):.1f} MiB "
            f"(AOT lower+compile {dt:.3f} s)")


def toed_parity(img, log=print) -> list:
    """TOED on the default device against the float64 oracle, with the
    tolerances of tests/test_toed.py. Returns failures."""
    import jax
    import numpy as np
    from scipy.spatial import cKDTree

    from edge_based_visual_odometry_tpu.ops import toed
    from tests import toed_oracle as oracle

    h, w = img.shape
    img64 = np.asarray(img, np.float64)
    t0 = time.perf_counter()
    Ix_o, Iy_o, mag_o, ori_o = oracle.oracle_gradient_field(img64)
    ref_edges = oracle.oracle_nms(Ix_o, Iy_o, mag_o, ori_o, h, w)
    log(f"TOED oracle (float64 NumPy, host): {len(ref_edges)} edges in "
        f"{time.perf_counter() - t0:.1f} s")
    img32 = np.asarray(img, np.float32)
    Ix, Iy, mag, ori = map(np.asarray,
                           jax.jit(toed.toed_gradient_field)(img32))
    fails = []
    for name, a, b in (("Ix", Ix, Ix_o), ("Iy", Iy, Iy_o),
                       ("mag", mag, mag_o)):
        bad = np.abs(a - b) > 2e-3 + 2e-4 * np.abs(b)
        log(f"TOED {name}: max |diff| {np.abs(a - b).max():.3e}, "
            f"{int(bad.sum())} of {bad.size} outside rtol 2e-4 atol 2e-3")
        if bad.any():
            fails.append(f"TOED {name}: {int(bad.sum())} values outside "
                         "rtol 2e-4, atol 2e-3")
    m = mag_o > 2.0
    dori = np.abs(ori[m] - ori_o[m])
    dori = np.minimum(dori, 2 * np.pi - dori)
    if not (np.quantile(dori, 0.999) < 1e-2 and dori.mean() < 1e-4):
        fails.append(f"TOED orientation: q99.9 {np.quantile(dori, 0.999)}"
                     f" mean {dori.mean()}")

    got = toed.detect_edges(img32, max_edges=65536)
    n = int(got.count)
    gx, gy, gt = (np.asarray(a)[:n] for a in (got.x, got.y, got.theta))
    ref = np.array([(e[0], e[1]) for e in ref_edges])
    ref_theta = np.array([e[2] for e in ref_edges])
    dist, nn = cKDTree(ref).query(np.stack([gx, gy], -1))
    dth = np.abs(gt - ref_theta[nn])
    dth = np.minimum(dth, 2 * np.pi - dth)
    q_pos, q_th = np.quantile(dist, 0.99), np.quantile(dth, 0.98)
    log(f"TOED edges: device {n}, oracle {len(ref_edges)}; subpixel "
        f"position q99 {q_pos:.3e} px; orientation q98 {q_th:.3e} rad")
    if abs(n - len(ref_edges)) > max(3, 0.01 * len(ref_edges)):
        fails.append(f"TOED edge count {n} vs oracle {len(ref_edges)}")
    if not q_pos < 0.05:
        fails.append(f"TOED subpixel positions: q99 {q_pos} px >= 0.05")
    if not q_th < 1e-2:
        fails.append(f"TOED orientations: q98 {q_th} rad >= 1e-2")
    return fails


def steps_parity(prod: bool = True, log=print) -> list:
    """Full stereo + temporal steps on this process's GPU against a CPU
    child (JAX_PLATFORMS=cpu, so it never opens the card)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import check_parity as CP

    label = "376x1241 VOConfig()" if prod else "240x320 reduced budgets"
    t0 = time.perf_counter()
    gpu = CP.collect(prod)
    t1 = time.perf_counter()
    cpu = CP.run_child("cpu", prod)
    t2 = time.perf_counter()
    log(f"steps parity ({label}): GPU leg {t1 - t0:.1f} s, CPU leg "
        f"{t2 - t1:.1f} s")
    return [] if CP.diff(cpu, gpu) else [f"GPU-vs-CPU step parity "
                                         f"({label}) failed"]


def device_time(fn, *args, n: int = 20) -> float:
    """Seconds per call over n back-to-back warm calls that end in
    block_until_ready: the device time of a device-bound call plus its
    share of dispatch."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def xla_baselines(seq, cfg, card: str, log=print):
    """Phase 4: XLA's warm device time for the two sites that once had
    hand-written kernels - the baseline a GPU kernel has to beat."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from edge_based_visual_odometry_tpu.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu.ops import image as IMG
    from edge_based_visual_odometry_tpu.ops import toed

    f0 = seq.frames[0]
    left = jnp.asarray(quantize(f0.left))
    right = jnp.asarray(quantize(f0.right))
    field = jax.jit(toed.toed_gradient_field)
    t = device_time(field, left)
    log(f"[{card}] XLA toed_gradient_field {left.shape[0]}x{left.shape[1]}:"
        f" {t * 1e3:.3f} ms")

    # GN input: every left TOED edge paired with right candidates around
    # its true match (ground-truth disparity +- up to 1.5 px), tiled to
    # the production max_refine_pairs budget.
    B = cfg.max_refine_pairs
    ed = toed.detect_edges(left, max_edges=cfg.max_edges)
    n = int(ed.count)
    rng = np.random.default_rng(0)
    pick = rng.integers(0, n, B)
    lx = np.asarray(ed.x)[:n][pick]
    ly = np.asarray(ed.y)[:n][pick]
    lt = np.asarray(ed.theta)[:n][pick]
    disp = f0.disparity[np.clip(np.round(ly).astype(int), 0, left.shape[0] - 1),
                        np.clip(np.round(lx).astype(int), 0, left.shape[1] - 1)]
    rx = (lx - disp + rng.uniform(-1.5, 1.5, B)).astype(np.float32)
    epi = np.tile(np.array([[1.0, 0.0]], np.float32), (B, 1))
    rgx, rgy = IMG.sobel_gradients(right)
    gn = jax.jit(lambda *a: GN.refine_along_epipolar_batch(
        *a, patch_size=cfg.patch_size, max_iter=cfg.gn_max_iter,
        tol=cfg.gn_tol, huber_delta=cfg.huber_delta, tile=cfg.gn_tile,
        chunk=cfg.gn_chunk, phase1_iters=cfg.gn_phase1_iters,
        phase2_budget=cfg.gn_phase2_budget,
        phase1_chunk=cfg.gn_phase1_chunk,
        weight_split=cfg.gn_weight_split))
    args = (left, right, rgx, rgy, jnp.asarray(lx), jnp.asarray(ly),
            jnp.asarray(lt), jnp.asarray(rx), jnp.asarray(ly),
            jnp.asarray(epi))
    t = device_time(gn, *args, n=10)
    res = gn(*args)
    log(f"[{card}] XLA refine_along_epipolar_batch {B} pairs: "
        f"{t * 1e3:.3f} ms ({float(jnp.mean(res.valid)):.3f} valid)")


def one_gpu_phases(cfg, card: str, dev, h: int = 376, w: int = 1241,
                   seed: int = 7, prod_parity: bool = True,
                   limits: dict = None):
    """Phases 2-4 on the default device. `limits` overrides
    check_frame_loop's keyword bounds and `prod_parity=False` diffs the
    steps at 240x320 instead of 376x1241 (small CPU rehearsals)."""
    import numpy as np

    def log(s):
        print(s, flush=True)

    # --- phase 2: production frame loop ---
    t0 = time.perf_counter()
    res = frame_loop(cfg, h=h, w=w, n_frames=8, seed=seed,
                     log=lambda s: log(f"[{card}] {s}"))
    log(f"[{card}] frame loop total wall {time.perf_counter() - t0:.3f} s "
        f"(8 frames, {res['ba_solves']} BA solves)")
    for k, (rot, tr) in enumerate(res["pose_errors"], start=1):
        log(f"pose error frame {k}: {rot:.4f} deg, {tr * 1e3:.3f} mm "
            f"(bound {MAX_ROT_DEG} deg, {MAX_TRANS_M * 1e3:.1f} mm)")
    warm = [r["wall_s"] for r in res["records"] if r["frame"] >= 3]
    log(f"[{card}] warm per-frame wall (frames 3-7): mean "
        f"{np.mean(warm):.4f} s, min {min(warm):.4f} s, max "
        f"{max(warm):.4f} s")
    first = [r["compile_s"] for r in res["records"][:3]]
    log(f"[{card}] cold XLA compile: stereo step (frame 0) {first[0]:.3f} s,"
        f" bootstrap temporal step + BA (frame 1) {first[1]:.3f} s, "
        f"temporal step + BA (frame 2) {first[2]:.3f} s")
    memory_report(res["pipe"], card, log=log)
    stats = dev.memory_stats()
    if stats:
        log(f"[{card}] peak_bytes_in_use after the loop: "
            f"{_mib(stats['peak_bytes_in_use']):.1f} MiB")
    fails = check_frame_loop(res, **(limits or {}))
    if fails:
        raise PhaseError("frame loop: " + "; ".join(fails))

    # --- phase 3: parity ---
    fails = toed_parity(quantize(res["seq"].frames[0].left), log=log)
    fails += steps_parity(prod_parity, log=log)
    if fails:
        raise PhaseError("parity: " + "; ".join(fails))

    # --- phase 4: XLA baselines ---
    xla_baselines(res["seq"], cfg, card, log=log)


def run_one_gpu(args) -> dict:
    import jax

    from edge_based_visual_odometry_tpu.config import VOConfig

    dev, card = device_gate()
    one_gpu_phases(VOConfig(), card, dev, seed=args.seed)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def four_device_checks(cfg, card: str, h: int = 376, w: int = 1241,
                       seed: int = 7, n_landmarks: int = 8192,
                       max_rot_deg: float = MAX_ROT_DEG,
                       max_trans_m: float = MAX_TRANS_M) -> list:
    """The two mesh paths on a flat 4-device mesh against the same work on
    the first device alone. Returns failures."""
    import jax
    import numpy as np

    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import ba as BA
    from edge_based_visual_odometry_tpu.parallel import mesh as PM
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tests.test_ba import make_problem

    mesh = PM.make_mesh(4)
    fails = []

    # sharded pair step: 4 distinct frame pairs, one per device
    seq = S.make_corridor_sequence(n_frames=5, h=h, w=w, seed=seed)
    fr = seq.frames
    kf_l = np.stack([quantize(fr[k].left) for k in range(4)])
    kf_r = np.stack([quantize(fr[k].right) for k in range(4)])
    cf_l = np.stack([quantize(fr[k + 1].left) for k in range(4)])
    cf_r = np.stack([quantize(fr[k + 1].right) for k in range(4)])
    R0 = np.stack([(fr[k + 1].R @ fr[k].R.T).astype(np.float32)
                   for k in range(4)])
    t0_ = np.stack([(fr[k + 1].t - fr[k + 1].R @ fr[k].R.T @ fr[k].t)
                    .astype(np.float32) for k in range(4)])
    seeds = np.arange(4, dtype=np.int32)
    batch = (kf_l, kf_r, cf_l, cf_r, R0, t0_, seeds)

    # the two programs compile concurrently (XLA compiles outside the
    # interpreter lock), which halves the wall of this phase
    dev0 = jax.devices()[0]
    shard = NamedSharding(mesh, P("frame"))
    batch4 = [jax.device_put(a, shard) for a in batch]
    pair0 = [jax.device_put(a[0], dev0) for a in batch]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        f4 = pool.submit(lambda: PM.build_sharded_pair_step(
            seq.rig, cfg, mesh).lower(*batch4).compile())
        f1 = pool.submit(lambda: jax.jit(PM.build_pair_step(
            seq.rig, cfg)).lower(*pair0).compile())
        sharded, single = f4.result(), f1.result()
    print(f"[{card}] sharded and one-device pair steps compiled in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = jax.block_until_ready(sharded(*batch4))
    ref = [jax.block_until_ready(
        single(*(jax.device_put(a[k], dev0) for a in batch)))
        for k in range(4)]
    print(f"[{card}] warm pair step: 4 devices "
          f"{device_time(sharded, *batch4, n=3):.4f} s per 4 pairs, one "
          f"device {device_time(single, *pair0, n=3):.4f} s per pair",
          flush=True)
    for k in range(4):
        R_s, t_s = np.asarray(out.R[k]), np.asarray(out.t[k])
        R_1, t_1 = np.asarray(ref[k][0]), np.asarray(ref[k][1])
        dang = rotation_deg(R_s.astype(np.float64) @ R_1.T)
        dt = float(np.linalg.norm(t_s - t_1))
        m_s = (int(out.n_mates_kf[k]), int(out.n_mates_cf[k]))
        m_1 = (int(ref[k][3]), int(ref[k][4]))
        print(f"pair {k}: sharded vs one device: rotation {dang:.5f} deg, "
              f"translation {dt * 1e3:.4f} mm, mates {m_s} vs {m_1}, "
              f"inlier ratio {float(out.inlier_ratio[k]):.4f} vs "
              f"{float(ref[k][2]):.4f}")
        if not (dang < max_rot_deg and dt < max_trans_m
                and all(min(a, b) > 0.97 * max(a, b)
                        for a, b in zip(m_s, m_1))):
            fails.append(f"pair {k} differs: {dang} deg, {dt} m, "
                         f"mates {m_s} vs {m_1}")

    # landmark-sharded BA (tests/test_ba.py's problem at window scale)
    p, *_ = make_problem(np.random.default_rng(42), Kn=4, L=n_landmarks)
    solve = jax.jit(lambda q: BA.run_ba(q, n_iters=5, damping=1e-3))
    one = solve(jax.device_put(p, jax.devices()[0]))
    repl = NamedSharding(mesh, P())
    p4 = p._replace(
        X=jax.device_put(p.X, shard), obs_kf=jax.device_put(p.obs_kf, shard),
        obs_lm=jax.device_put(p.obs_lm, shard),
        obs_uv=jax.device_put(p.obs_uv, shard),
        obs_w=jax.device_put(p.obs_w, shard), R=jax.device_put(p.R, repl),
        t=jax.device_put(p.t, repl), K_cam=jax.device_put(p.K_cam, repl))
    four = solve(p4)
    dR = float(np.max(np.abs(np.asarray(four.R) - np.asarray(one.R))))
    dT = float(np.max(np.abs(np.asarray(four.t) - np.asarray(one.t))))
    c1, c4 = np.asarray(one.cost_history), np.asarray(four.cost_history)
    dc = float(np.max(np.abs(c4 - c1) / np.maximum(np.abs(c1), 1e-30)))
    print(f"BA (4 keyframes, {n_landmarks} landmarks, 5 iterations): "
          f"sharded vs one device max |dR| {dR:.3e}, max |dt| {dT:.3e}, "
          f"cost rel diff {dc:.3e} (limits 5e-4, 5e-4, 5e-3)")
    if not (dR < 5e-4 and dT < 5e-4 and dc < 5e-3):
        fails.append(f"sharded BA differs: {dR}, {dT}, {dc}")
    return fails


def run_four_gpus(args) -> dict:
    import jax

    from edge_based_visual_odometry_tpu.config import VOConfig

    dev, card = device_gate(expect_count=4)
    fails = four_device_checks(VOConfig(), card, seed=args.seed)
    if fails:
        raise PhaseError("four GPUs: " + "; ".join(fails))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7,
                    help="synthetic scene seed")
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh paths against one GPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    try:
        device = run_four_gpus(args) if args.four else run_one_gpu(args)
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
