"""Device-mesh scaling of the VO pipeline.

The reference's only parallelism is intra-host OpenMP (SURVEY.md §2.2).
Here it is replaced by SPMD over a flat jax.sharding.Mesh:

  - axis "frame": data parallelism over stereo frame pairs - the natural
    production deployment (shard a KITTI sweep across devices). Detection,
    matching, temporal association and pose solve all run per-pair with no
    cross-pair dependencies; aggregate statistics are reduced by the
    all-reduce XLA inserts for the mean over the sharded axis.
  - windowed BA (models/ba.py) shards keyframe blocks over the same mesh
    and psum-reduces Schur complements.

All sharding is GSPMD: we annotate in/out shardings and let XLA insert
collectives.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from edge_based_visual_odometry_tpu import geometry as geom
from edge_based_visual_odometry_tpu.config import StereoRig, VOConfig
from edge_based_visual_odometry_tpu.models import motion_tracker as MT
from edge_based_visual_odometry_tpu.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu.models.types import FrameData, RigArrays
from edge_based_visual_odometry_tpu.ops import image as IMG
from edge_based_visual_odometry_tpu.ops import toed


def make_mesh(n_devices: Optional[int] = None, axis: str = "frame") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            # silent truncation would e.g. make analyze_production_memory
            # report an 8x workload as "per-device"
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are visible (set XLA_FLAGS="
                "--xla_force_host_platform_device_count=N for a virtual "
                "CPU mesh)")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Mesh:
    """Multi-host entry point: initialize jax.distributed and return the
    global frame mesh over every device of every process. Without a
    cluster environment JAX can detect, pass all three arguments
    (coordinator_address="localhost:<port>" for processes on one host).

    The per-pair pipeline has no cross-pair dependencies, so the same
    `build_sharded_pair_step` works unchanged: frame-pair batches shard over
    all processes' devices, and the only cross-device traffic is the final
    scalar AllReduce. Launch the same script per process with local input
    shards (jax.make_array_from_process_local_data) - see
    tests/test_parallel.py for the single-host virtual-mesh equivalent.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return make_mesh()


class PairStepOutput(NamedTuple):
    R: jnp.ndarray              # (B, 3, 3) relative poses KF->CF
    t: jnp.ndarray              # (B, 3)
    inlier_ratio: jnp.ndarray   # (B,)
    n_mates_kf: jnp.ndarray     # (B,)
    n_mates_cf: jnp.ndarray
    mean_inlier_ratio: jnp.ndarray  # () - psum-style global mean over the mesh


def build_pair_step(rig: StereoRig, cfg: VOConfig):
    """Per-element full pipeline: (kf_left, kf_right, cf_left, cf_right,
    rel_R_init, rel_t_init, seed) -> pose + stats. vmap/shard over leading
    batch."""
    rig_arrays = RigArrays.from_rig(rig)
    gather_ry = SM.derive_gather_band(rig, cfg)
    dist_l = jnp.asarray(rig.left.distortion[:4], jnp.float32)
    dist_r = jnp.asarray(rig.right.distortion[:4], jnp.float32)
    need_ul = any(abs(d) > 0 for d in rig.left.distortion[:4])
    need_ur = any(abs(d) > 0 for d in rig.right.distortion[:4])

    def one_pair(kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seed):
        def prep(l, r):
            # lens undistortion, matching pipeline.build_stereo_step
            # (without it the sharded path would silently run distorted)
            if need_ul:
                l = IMG.undistort(l, rig_arrays.K_left, dist_l)
            if need_ur:
                r = IMG.undistort(r, rig_arrays.K_right, dist_r)
            lgx, lgy = IMG.sobel_gradients(l)
            rgx, rgy = IMG.sobel_gradients(r)
            fr = FrameData(l, r, lgx, lgy, rgx, rgy)
            le = toed.detect_edges(l, cfg.toed_kernel_size, cfg.toed_sigma,
                                   cfg.toed_grad_mag_min, cfg.max_edges,
                                   cfg.toed_border)
            re = toed.detect_edges(r, cfg.toed_kernel_size, cfg.toed_sigma,
                                   cfg.toed_grad_mag_min, cfg.max_edges,
                                   cfg.toed_border)
            mates, _, _ = SM.match_stereo(le, re, fr, rig_arrays, cfg,
                                          gather_ry=gather_ry)
            return fr, mates

        kf_frame, kf_mates = prep(kf_l.astype(jnp.float32),
                                  kf_r.astype(jnp.float32))
        cf_frame, cf_mates = prep(cf_l.astype(jnp.float32),
                                  cf_r.astype(jnp.float32))
        rel = geom.Pose(rel_R0, rel_t0)
        quads, _ = TM.match_temporal(kf_mates, cf_mates, kf_frame, cf_frame,
                                     rel, rig_arrays, cfg, use_gt=False)
        pq = MT.lift_quads(kf_mates, quads, rig_arrays, cfg, use_gt=False)
        res = MT.estimate_pose(pq, rig_arrays, cfg, seed)
        return (res.R, res.t, res.inlier_ratio,
                kf_mates.count, cf_mates.count)

    return one_pair


def build_sharded_pair_step(rig: StereoRig, cfg: VOConfig, mesh: Mesh):
    """jit the batched pair step with the batch sharded over mesh axis
    'frame'. The final global mean is an all-reduce over the mesh."""
    one_pair = build_pair_step(rig, cfg)
    batched = jax.vmap(one_pair)

    def step(kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seeds):
        R, t, ratio, n_kf, n_cf = batched(
            kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seeds)
        # cross-device reduction (XLA emits an AllReduce over "frame")
        mean_ratio = jnp.mean(ratio)
        return PairStepOutput(R, t, ratio, n_kf, n_cf, mean_ratio)

    shard = NamedSharding(mesh, P("frame"))
    repl = NamedSharding(mesh, P())
    in_shardings = (shard,) * 7
    out_shardings = PairStepOutput(shard, shard, shard, shard, shard, repl)
    return jax.jit(step, in_shardings=in_shardings,
                   out_shardings=out_shardings)


def device_memory_budget(device=None,
                         budget_bytes: Optional[int] = None) -> int:
    """Bytes a program may hold on `device` (default: the first device):
    `budget_bytes` when the caller gives one, else the allocator's limit
    from device.memory_stats()["bytes_limit"]. A device that reports no
    memory statistics (the CPU) has no such limit, so without a budget
    this raises rather than guess one."""
    if budget_bytes is not None:
        return int(budget_bytes)
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError(
            f"{device.platform} device {device.id} reports no memory limit; "
            "pass budget_bytes explicitly")
    return int(stats["bytes_limit"])


def analyze_production_memory(n_devices: int = 8, h: int = 376,
                              w: int = 1241,
                              cfg: Optional[VOConfig] = None,
                              budget_bytes: Optional[int] = None) -> dict:
    """AOT-compile the sharded pair step at PRODUCTION shapes (default:
    KITTI 376x1241, production VOConfig budgets) on an n-device mesh and
    report XLA's per-device memory analysis - no execution, so it runs on
    the virtual CPU mesh. Answers the question dryrun_multichip's tiny
    shapes cannot: does one frame-pair per device fit in device memory?

    Returns {'argument_mib', 'output_mib', 'temp_mib', 'total_mib',
    'budget_mib', 'fits_memory'} with sizes in MiB per device; the budget
    comes from device_memory_budget (explicit on the CPU).
    """
    cfg = cfg or VOConfig()
    from edge_based_visual_odometry_tpu.io import synthetic as S

    mesh = make_mesh(n_devices)
    budget = device_memory_budget(mesh.devices.flat[0], budget_bytes)
    rig = S.default_rig(h, w)
    step = build_sharded_pair_step(rig, cfg, mesh)

    B = n_devices
    img = jax.ShapeDtypeStruct((B, h, w), jnp.float32)
    R0 = jax.ShapeDtypeStruct((B, 3, 3), jnp.float32)
    t0 = jax.ShapeDtypeStruct((B, 3), jnp.float32)
    seeds = jax.ShapeDtypeStruct((B,), jnp.int32)
    compiled = step.lower(img, img, img, img, R0, t0, seeds).compile()
    ma = compiled.memory_analysis()
    mib = 1024.0 * 1024.0
    out = {
        "argument_mib": ma.argument_size_in_bytes / mib,
        "output_mib": ma.output_size_in_bytes / mib,
        "temp_mib": ma.temp_size_in_bytes / mib,
    }
    out["total_mib"] = sum(out.values())
    out["budget_mib"] = budget / mib
    out["fits_memory"] = out["total_mib"] < out["budget_mib"]
    return out


def dryrun_multichip(n_devices: int, h: int = 64, w: int = 96) -> None:
    """Compile + execute the full sharded pipeline step on an n-device
    mesh with tiny shapes (driver entry; see __graft_entry__.py)."""
    from edge_based_visual_odometry_tpu.io import synthetic as S

    cfg = VOConfig(max_edges=512, max_candidates=8, gather_slots=32,
                   max_mates=256, max_refine_pairs=512,
                   max_quad_candidates=8, quad_gather_slots=80,
                   ransac_max_iterations=64, gn_max_iter=3)
    seq = S.make_sequence(n_frames=2, h=h, w=w)
    rig = seq.rig
    mesh = make_mesh(n_devices)
    step = build_sharded_pair_step(rig, cfg, mesh)

    B = n_devices
    kf_l = jnp.broadcast_to(jnp.asarray(seq.frames[0].left), (B, h, w))
    kf_r = jnp.broadcast_to(jnp.asarray(seq.frames[0].right), (B, h, w))
    cf_l = jnp.broadcast_to(jnp.asarray(seq.frames[1].left), (B, h, w))
    cf_r = jnp.broadcast_to(jnp.asarray(seq.frames[1].right), (B, h, w))
    rel_R0 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (B, 3, 3))
    rel_t0 = jnp.zeros((B, 3), jnp.float32)
    seeds = jnp.arange(B, dtype=jnp.int32)

    out = step(kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seeds)
    jax.block_until_ready(out)
    assert out.R.shape == (B, 3, 3)
    assert np.isfinite(float(out.mean_inlier_ratio))

    # Also exercise the sharded windowed-BA path (landmark/observation
    # axes sharded over the same mesh, Schur blocks psum-reduced): a
    # 3-frame VO loop with ba_window=2 runs the full in-loop
    # solve on the mesh, not just the pair step.
    from edge_based_visual_odometry_tpu.models.pipeline import VOPipeline
    pipe = VOPipeline(rig=rig, cfg=cfg, ba_window=2, ba_mesh=mesh)
    seq3 = S.make_sequence(n_frames=3, h=h, w=w)
    for f in seq3.frames:
        pipe.run_frame(f.left, f.right)
    assert len(pipe.trajectory) == 3
    for pose in pipe.trajectory:
        assert np.isfinite(np.asarray(pose.R)).all()
        assert np.isfinite(np.asarray(pose.t)).all()
    assert pipe.wba.kf_poses, "BA window never populated"
