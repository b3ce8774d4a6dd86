"""chip_smoke.py and what it stands on, as far as the CPU can check them:
the device gate refuses the CPU, the frame-loop and TOED phases run at a
tiny size, the compile cache lands where it should, and the step-parity
diff judges agreement, divergence and collapse correctly."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke as C  # noqa: E402
import check_parity as CP  # noqa: E402

# the tiny configuration of parallel/mesh.dryrun_multichip
SMALL = dict(max_edges=512, max_candidates=8, gather_slots=32,
             max_mates=256, max_refine_pairs=512, max_quad_candidates=8,
             quad_gather_slots=80, ransac_max_iterations=64, gn_max_iter=3)


def _env_without(*names):
    return {k: v for k, v in os.environ.items() if k not in names}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_gate_refuses_cpu(where, tmp_path):
    """On the CPU, and in a directory holding only the script, the smoke
    run exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = _env_without("PYTHONPATH")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    if where == "repo":
        assert "no GPU" in out.stderr


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env-set", "env-unset"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the package
    pins the cache to <repo>/.jax_cache, a fixed path (the path is part
    of the cache key, so a per-process or temp path would never hit)."""
    env = _env_without("JAX_COMPILATION_CACHE_DIR")
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, edge_based_visual_odometry_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    got = out.stdout.strip().splitlines()[-1]
    if env_dir:
        assert got == str(tmp_path / "cc")
    else:
        assert got == os.path.join(REPO, ".jax_cache")
        assert str(os.getpid()) not in got and "tmp" not in got.lower()


def _counts(mates, quads, edges=(1000, 1000), stage=100):
    return {"edges": list(edges), "mates": mates, "quads": quads,
            "stereo_pairs": [stage] * 4, "temporal_pairs": [stage] * 3}


@pytest.mark.parametrize("dev,ok,message", [
    (_counts(1010, 505, edges=(1001, 1000), stage=103), True, None),
    (_counts(900, 500), False, "DIVERGENCE at mates"),
    (_counts(1000, 500, stage=50), False, "DIVERGENCE at stereo_pairs[0]"),
], ids=["agree", "mates-diverge", "stage-diverge"])
def test_parity_diff(dev, ok, message, capsys):
    ref = _counts(1000, 500)
    assert CP.diff(ref, dev) is ok
    if message:
        assert message in capsys.readouterr().out


def test_parity_diff_both_collapsed(capsys):
    """A collapse to zero on both backends is not agreement."""
    z = _counts(0, 0, stage=0)
    assert CP.diff(z, dict(z)) is False
    assert "WORKLOAD COLLAPSED" in capsys.readouterr().out


def test_frame_loop_phase_small():
    """The phase-2 frame loop at 64x96 on the CPU: every frame gets a
    finite pose, the BA window solves, and the records carry what the
    card run prints."""
    from edge_based_visual_odometry_tpu.config import VOConfig

    res = C.frame_loop(VOConfig(**SMALL), h=64, w=96, n_frames=4,
                       log=lambda s: None)
    assert res["n_poses"] == 4 and res["poses_finite"]
    assert res["ba_solves"] >= 1
    assert [r["frame"] for r in res["records"]] == [0, 1, 2, 3]
    assert res["records"][0]["quads"] is None
    assert all(r["quads"] is not None for r in res["records"][1:])
    assert len(res["pose_errors"]) == 3
    # the loose limits pass; the production workload guard cannot hold
    # at this size and must say so
    assert C.check_frame_loop(res, min_mates=1, min_quads=1,
                              max_rot_deg=180.0, max_trans_m=100.0) == []
    assert any("mates" in f for f in C.check_frame_loop(res))


def test_toed_parity_phase_small():
    """Phase 3's TOED-vs-float64-oracle comparison on a small corridor
    frame (CPU backend)."""
    from edge_based_visual_odometry_tpu.io import synthetic as S

    seq = S.make_corridor_sequence(n_frames=1, h=64, w=96)
    assert C.toed_parity(C.quantize(seq.frames[0].left),
                         log=lambda s: None) == []


def test_rotation_deg_small_angles():
    """The pose-error angle is exact near zero, where arccos of the trace
    loses every digit in f32."""
    a = 1e-4
    R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                  [0.0, 0.0, 1.0]])
    assert C.rotation_deg(R) == pytest.approx(np.degrees(a), rel=1e-6)
    assert C.rotation_deg(np.eye(3)) == 0.0


@pytest.fixture()
def gpu_env():
    """Environment for a child that may use the GPU; skips where none is
    visible. Decided here, at run time, never while collecting."""
    env = _env_without("JAX_PLATFORMS", "XLA_FLAGS")
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no nvidia-smi: this test needs a GPU")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip("JAX sees no GPU")
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    """The whole smoke run on the card (run with `pytest -m gpu`)."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=gpu_env, capture_output=True, text=True,
                         timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
