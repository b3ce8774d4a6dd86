#!/usr/bin/env python
"""Per-stage device timing of the pipeline at KITTI resolution.

Run on the GPU: python benchmarks/profile_stages.py
Times each jitted phase separately (post-compile) to direct kernel
optimization work.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax
import jax.numpy as jnp
import numpy as np


def bench(fn, *args, n=10):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3  # ms


def main():
    from edge_based_visual_odometry_tpu import geometry as geom
    from edge_based_visual_odometry_tpu.config import VOConfig
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu.models import stereo_matcher as SM
    from edge_based_visual_odometry_tpu.models import temporal_matcher as TM
    from edge_based_visual_odometry_tpu.models.types import FrameData, RigArrays
    from edge_based_visual_odometry_tpu.ops import descriptors as DESC
    from edge_based_visual_odometry_tpu.ops import image as IMG
    from edge_based_visual_odometry_tpu.ops import patches as P
    from edge_based_visual_odometry_tpu.ops import toed

    H, W = 376, 1241
    cfg = VOConfig()
    seq = S.make_sequence(n_frames=2, h=H, w=W)
    rig = RigArrays.from_rig(seq.rig)
    f0, f1 = seq.frames[0], seq.frames[1]

    dev = jax.devices()[0]
    left = jax.device_put(jnp.asarray(f0.left), dev)
    right = jax.device_put(jnp.asarray(f0.right), dev)

    grads = jax.jit(lambda a: IMG.sobel_gradients(a))
    print(f"sobel x1:        {bench(grads, left):8.2f} ms", flush=True)

    det = jax.jit(lambda a: toed.detect_edges(a, max_edges=cfg.max_edges))
    print(f"toed x1:         {bench(det, left):8.2f} ms", flush=True)

    led = det(left)
    red = det(right)
    lgx, lgy = grads(left)
    rgx, rgy = grads(right)
    frame = FrameData(left, right, lgx, lgy, rgx, rgy)

    from edge_based_visual_odometry_tpu.ops import toed as TOED_MOD
    gradf = jax.jit(lambda a: TOED_MOD.toed_gradient_field(a))
    print(f"toed grad:       {bench(gradf, left):8.2f} ms", flush=True)
    g4 = gradf(left)
    nmsf = jax.jit(lambda a, b, c, d: TOED_MOD.toed_nms_subpixel(a, b, c, d))
    print(f"toed nms:        {bench(nmsf, *g4):8.2f} ms", flush=True)
    nn = nmsf(*g4)
    extf = jax.jit(lambda sx, sy, sm, o, v: TOED_MOD.extract_edges(
        sx, sy, sm, o, v, left.shape[0], left.shape[1], cfg.max_edges))
    print(f"toed extract:    {bench(extf, nn[0], nn[1], nn[2], g4[3], nn[3]):8.2f} ms", flush=True)

    descf = jax.jit(lambda gx, gy, e: DESC.edge_descriptors_tiled(
        gx, gy, e.x, e.y, e.theta, chunk=cfg.sample_chunk))
    print(f"descriptors x1:  {bench(descf, lgx, lgy, led):8.2f} ms", flush=True)

    patchf = jax.jit(lambda img, e: P.edge_patches_tiled(
        img, e.x, e.y, e.theta, cfg.patch_size, cfg.orthogonal_shift_mag,
        chunk=cfg.sample_chunk))
    print(f"patches x1:      {bench(patchf, left, led):8.2f} ms", flush=True)

    import jax.numpy as jnp2
    from edge_based_visual_odometry_tpu.ops import gauss_newton as GNOPS
    B = cfg.max_refine_pairs
    import numpy as np2
    rngp = np2.random.default_rng(0)
    lxs = jnp.asarray(rngp.uniform(30, W - 30, B).astype(np2.float32))
    lys = jnp.asarray(rngp.uniform(30, H - 30, B).astype(np2.float32))
    lts = jnp.asarray(rngp.uniform(-3, 3, B).astype(np2.float32))
    eds = jnp.asarray(np2.tile([[1.0, 0.0]], (B, 1)).astype(np2.float32))
    act = jnp.asarray(np2.arange(B) < B // 2)
    gnf = jax.jit(lambda a, b, c, d, e, f: GNOPS.refine_along_epipolar_batch(
        left, right, rgx, rgy, a, b, c, d, e, f,
        chunk=cfg.sample_chunk, active=act))
    print(f"gn 1dof (50% of {B}): {bench(gnf, lxs, lys, lts, lxs - 8, lys, eds):8.2f} ms", flush=True)

    stereo = jax.jit(lambda a, b, fr: SM.match_stereo(a, b, fr, rig, cfg))
    print(f"stereo cascade:  {bench(stereo, led, red, frame):8.2f} ms", flush=True)

    mates0, _, _ = stereo(led, red, frame)
    led1 = det(jax.device_put(jnp.asarray(f1.left), dev))
    red1 = det(jax.device_put(jnp.asarray(f1.right), dev))
    l1gx, l1gy = grads(jax.device_put(jnp.asarray(f1.left), dev))
    r1gx, r1gy = grads(jax.device_put(jnp.asarray(f1.right), dev))
    frame1 = FrameData(jax.device_put(jnp.asarray(f1.left), dev),
                       jax.device_put(jnp.asarray(f1.right), dev),
                       l1gx, l1gy, r1gx, r1gy)
    mates1, _, _ = stereo(led1, red1, frame1)

    ident = geom.Pose.identity()
    temporal = jax.jit(lambda m0, m1, fr0, fr1: TM.match_temporal(
        m0, m1, fr0, fr1, ident, rig, cfg, use_gt=False))
    print(f"temporal:        {bench(temporal, mates0, mates1, frame, frame1):8.2f} ms", flush=True)

    quads, _ = temporal(mates0, mates1, frame, frame1)
    lift = jax.jit(lambda m, q: MT.lift_quads(m, q, rig, cfg, use_gt=False))
    print(f"lift_quads:      {bench(lift, mates0, quads):8.2f} ms", flush=True)

    pq = lift(mates0, quads)
    pose = jax.jit(lambda q: MT.estimate_pose(q, rig, cfg, jnp.int32(0)))
    print(f"ransac+refine:   {bench(pose, pq):8.2f} ms", flush=True)


if __name__ == "__main__" and "--ablate" not in sys.argv:
    main()


def ablate():
    """Config-probe decomposition of the composed steps: time the stereo/
    temporal steps under configs that stub out one cost center each
    (isolated jits of one stage can mislead: XLA fuses the composed step
    differently)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.config import VOConfig
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    H, W = 376, 1241
    seq = S.make_sequence(n_frames=2, h=H, w=W)
    base = VOConfig()
    variants = {
        "base": base,
        "gn_chunk_2048": dataclasses.replace(base, gn_chunk=2048),
        "gate_chunk_16k": dataclasses.replace(base, gate_chunk=16384),
        "sample_chunk_1k": dataclasses.replace(base, sample_chunk=1024),
        "gn_iter1": dataclasses.replace(base, gn_max_iter=1,
                                        gn_phase1_iters=0),
        "refine_budget_1k": dataclasses.replace(base, max_refine_pairs=1024),
        # TOED-cost isolator: detection runs at full res regardless of
        # max_edges (only extraction capacity shrinks), so base - edges_2k
        # ~= the cascade's share of the stereo step.
        "edges_2k": dataclasses.replace(base, max_edges=2048),
        # temporal decomposition: each variant stubs one temporal cost
        # center.
        "ransac_iters_64": dataclasses.replace(base,
                                               ransac_max_iterations=64),
        "cq_24": dataclasses.replace(base, max_quad_candidates=24),
        "pose_quads_16k": dataclasses.replace(base, max_pose_quads=16384),
        "gather_slots_288": dataclasses.replace(base, quad_gather_slots=288),
        "mates_8k": dataclasses.replace(base, max_mates=8192),
    }
    l0 = jnp.asarray(seq.frames[0].left)
    r0 = jnp.asarray(seq.frames[0].right)
    l1 = jnp.asarray(seq.frames[1].left)
    r1 = jnp.asarray(seq.frames[1].right)
    I = jnp.eye(3, dtype=jnp.float32)
    z = jnp.zeros((3,), jnp.float32)
    for name, cfg in variants.items():
        sstep = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
        tstep = PL.build_temporal_step(seq.rig, cfg, use_gt=False)
        kf = jax.block_until_ready(sstep(l0, r0))
        cf = jax.block_until_ready(sstep(l1, r1))
        # bootstrap-then-predict (see bench.py): time the steady-state
        # workload under a realistic prediction
        trb = jax.block_until_ready(tstep(kf.mates, kf.frame, cf.mates,
                                          cf.frame, I, z, jnp.int32(0)))
        s_ms = bench(sstep, l1, r1, n=6)
        t_ms = bench(lambda *a: tstep(*a, trb.R, trb.t, jnp.int32(0)),
                     kf.mates, kf.frame, cf.mates, cf.frame, n=6)
        print(f"{name:18s} stereo {s_ms:7.1f} ms   temporal {t_ms:7.1f} ms",
              flush=True)


if __name__ == "__main__" and "--ablate" in sys.argv:
    sys.exit(ablate())
