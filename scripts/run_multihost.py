"""Multi-process scaling harness for the sharded VO pair step.

The reference's only parallelism is intra-host OpenMP; here the scaling
path is SPMD over a global jax.sharding.Mesh spanning every device of
every process (parallel/mesh.py). This script is the runnable protocol
artifact for BASELINE.md's ">=70% scaling efficiency at 2 hosts" gate:

  One process driving every local GPU (or rehearsal on the virtual CPU
  mesh):
    python scripts/run_multihost.py --batch_per_device 1 --steps 4

  Several processes (launch the SAME command in every process; nothing
  tells JAX of a cluster, so all three arguments are needed):
    python scripts/run_multihost.py \
        --coordinator localhost:8476 --num_processes 2 --process_id $RANK

  Virtual 8-device rehearsal (no GPU needed; exactly the code path the
  tests exercise):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/run_multihost.py --steps 2 --size small

Protocol (documented in docs/SCALING.md): measure steady-state
frames/s at batch_per_device=const for 1 device, 1 host, 2 hosts; scaling
efficiency = fps(N devices) / (N * fps(1 device)). Every process must see
only its own process-local shard - inputs are assembled with
jax.make_array_from_process_local_data, so no process materializes the
global batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from edge_based_visual_odometry_tpu.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu.parallel import mesh as PM  # noqa: E402

SIZES = {
    # (h, w, cfg overrides) - 'small' for CPU rehearsal, 'kitti' for GPUs
    "small": (64, 96, dict(max_edges=512, max_candidates=8, gather_slots=32,
                           max_mates=256, max_refine_pairs=512,
                           max_quad_candidates=8, quad_gather_slots=80,
                           ransac_max_iterations=64, gn_max_iter=3)),
    "kitti": (376, 1241, {}),
}


def build_local_inputs(mesh: Mesh, batch_per_device: int, h: int, w: int):
    """Per-process input shards -> global sharded arrays.

    Each process renders only its own frames (process-local numpy), then
    jax.make_array_from_process_local_data assembles the global array
    without any host holding the full batch.
    """
    n_local = batch_per_device * jax.local_device_count()
    n_global = batch_per_device * jax.device_count()
    seq = S.make_sequence(n_frames=2, h=h, w=w)
    f0, f1 = seq.frames

    def tile(img):
        return np.broadcast_to(np.asarray(img, np.float32),
                               (n_local, h, w)).copy()

    shard = NamedSharding(mesh, P("frame"))
    local = {
        "kf_l": tile(f0.left), "kf_r": tile(f0.right),
        "cf_l": tile(f1.left), "cf_r": tile(f1.right),
        "rel_R0": np.broadcast_to(np.eye(3, dtype=np.float32),
                                  (n_local, 3, 3)).copy(),
        "rel_t0": np.zeros((n_local, 3), np.float32),
        "seeds": (np.arange(n_local, dtype=np.int32)
                  + jax.process_index() * n_local),
    }
    global_arrays = {
        k: jax.make_array_from_process_local_data(
            shard, v, (n_global,) + v.shape[1:])
        for k, v in local.items()
    }
    return global_arrays, seq.rig


def measure(step, arrays, steps: int, warmup: int = 1):
    order = ("kf_l", "kf_r", "cf_l", "cf_r", "rel_R0", "rel_t0", "seeds")
    args = [arrays[k] for k in order]
    for _ in range(warmup):
        out = step(*args)
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step(*args)
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / steps
    return dt, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-host only)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--batch_per_device", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--size", choices=sorted(SIZES), default="kitti")
    args = ap.parse_args(argv)

    if args.coordinator is not None or args.num_processes not in (None, 1):
        jax.distributed.initialize(coordinator_address=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id)

    mesh = PM.make_mesh()
    h, w, over = SIZES[args.size]
    cfg = VOConfig(**over)
    arrays, rig = build_local_inputs(mesh, args.batch_per_device, h, w)
    step = PM.build_sharded_pair_step(rig, cfg, mesh)

    dt, out = measure(step, arrays, args.steps)
    n_dev = jax.device_count()
    fps = args.batch_per_device * n_dev / dt
    result = {
        "devices": n_dev,
        "hosts": jax.process_count(),
        "batch_per_device": args.batch_per_device,
        "sec_per_step": round(dt, 4),
        "frame_pairs_per_s": round(fps, 3),
        "per_device_fps": round(fps / n_dev, 3),
        "mean_inlier_ratio": float(out.mean_inlier_ratio),
    }
    if jax.process_index() == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
