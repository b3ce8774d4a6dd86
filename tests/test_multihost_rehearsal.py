"""Virtual-mesh rehearsal of the EXACT multi-host harness code path:
scripts/run_multihost.py's input assembly via
jax.make_array_from_process_local_data + sharded step + measurement,
on the 8-device CPU mesh (conftest.py sets the platform flags)."""

import numpy as np
import pytest

import jax

from edge_based_visual_odometry_tpu.config import VOConfig
from edge_based_visual_odometry_tpu.parallel import mesh as PM

pytestmark = pytest.mark.heavy  # multi-second jitted integration programs


def test_run_multihost_rehearsal():
    from scripts.run_multihost import SIZES, build_local_inputs, measure

    mesh = PM.make_mesh()
    assert mesh.devices.size == 8
    h, w, over = SIZES["small"]
    arrays, rig = build_local_inputs(mesh, batch_per_device=1, h=h, w=w)
    # every input is globally (8, ...) and frame-sharded, one shard per
    # device, assembled from process-local data
    assert arrays["kf_l"].shape == (8, h, w)
    assert len(arrays["kf_l"].addressable_shards) == 8

    step = PM.build_sharded_pair_step(rig, VOConfig(**over), mesh)
    dt, out = measure(step, arrays, steps=1, warmup=1)
    assert dt > 0
    assert out.R.shape == (8, 3, 3)
    assert np.isfinite(float(out.mean_inlier_ratio))


def test_run_multihost_main_single_process():
    """main() end-to-end in single-process mode (no jax.distributed)."""
    from scripts.run_multihost import main

    res = main(["--steps", "1", "--size", "small"])
    assert res["devices"] == 8
    assert res["hosts"] == 1
    assert res["frame_pairs_per_s"] > 0


@pytest.mark.slow
def test_production_shapes_fit_memory():
    """AOT memory analysis of the sharded pair step at PRODUCTION KITTI
    shapes (376x1241, full VOConfig budgets) on the 8-device mesh: the
    per-device footprint must fit the budget (tiny-shape dryruns prove
    nothing about the production footprint). Compile only - no
    execution - so the virtual CPU mesh suffices; the CPU reports no
    memory limit, so the budget is explicit."""
    from edge_based_visual_odometry_tpu.parallel import mesh as PM

    r = PM.analyze_production_memory(8, budget_bytes=16 * 2**30)
    assert r["fits_memory"], r
    # sanity: the analysis saw a real program, not a trivially-DCE'd one
    assert r["temp_mib"] > 100, r
    # footprint regression guard: the fused pair step (stereo kf + stereo
    # cf + temporal in one program) at the keep-everything capacity
    # defaults (max_mates 24576, refine-all, Cq=32) sits near 11 GiB per
    # device; growth past 13 GiB is a layout or capacity regression.
    assert r["total_mib"] < 13312, r


def test_memory_budget_requires_explicit_budget_on_cpu():
    """The CPU reports no memory statistics: the budget reader refuses to
    guess one, and an explicit budget passes through unchanged."""
    cpu = jax.devices("cpu")[0]
    assert cpu.memory_stats() is None
    with pytest.raises(ValueError, match="budget_bytes"):
        PM.device_memory_budget(cpu)
    assert PM.device_memory_budget(cpu, budget_bytes=1 << 30) == 1 << 30
