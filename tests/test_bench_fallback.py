"""bench.py's reporting logic with the device work monkeypatched out.

bench.py reports a frame rate only for a GPU run whose workload guard
held: without a GPU it exits non-zero and prints no rate, and a collapsed
workload reports an error with value 0.0. Every result names its device.
"""

import importlib.util
import json
import os

import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")

FAKE_GPU = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
            "count": 1, "gpu_name": "NVIDIA H100 80GB HBM3",
            "power_limit": "700.00 W"}


@pytest.fixture()
def bench_mod(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "whole_frame_baseline", lambda h, w: 209.4)
    # stub the synthetic render and the device gate out of the
    # decision-logic tests
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.utils import device as DEV
    monkeypatch.setattr(S, "make_sequence",
                        lambda n_frames, h, w: object())
    monkeypatch.setattr(DEV, "require_gpu", lambda min_count=1: FAKE_GPU)
    return mod


def _run_main(mod, capsys):
    rc = mod.main()
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])   # contract: ONE JSON line on stdout
    return rc, payload


def test_default_dense_ok(bench_mod, monkeypatch, capsys):
    calls = []

    def fake_run_workload(seq, n):
        calls.append(n)
        return 2.0, "mates=9999 quads=9999 inlier_ratio=0.9"

    monkeypatch.setattr(bench_mod, "run_workload", fake_run_workload)
    rc, payload = _run_main(bench_mod, capsys)
    assert rc == 0
    assert calls == [12]
    assert payload["value"] == 2.0
    assert payload["vs_baseline"] == pytest.approx(2.0 * 209.4, rel=0.01)
    assert "baseline_hw" in payload
    for key in ("platform", "device_kind", "gpu_name", "power_limit"):
        assert payload[key] == FAKE_GPU[key]


def test_all_collapse_reports_error(bench_mod, monkeypatch, capsys):
    monkeypatch.setattr(bench_mod, "run_workload",
                        lambda seq, n: (None, "workload collapsed: mates=0"))
    rc, payload = _run_main(bench_mod, capsys)
    assert rc == 1
    assert payload["value"] == 0.0
    assert "collapsed" in payload["error"]
    assert payload["platform"] == "gpu"


def test_no_gpu_exits_without_a_rate(bench_mod, monkeypatch, capsys):
    from edge_based_visual_odometry_tpu.utils import device as DEV

    def no_gpu(min_count=1):
        raise DEV.NoGPUError("JAX's first device is cpu")

    monkeypatch.setattr(DEV, "require_gpu", no_gpu)
    monkeypatch.setattr(bench_mod, "run_workload",
                        lambda seq, n: pytest.fail("ran without a GPU"))
    assert bench_mod.main() != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert "needs a GPU" in captured.err


def test_require_gpu_refuses_the_cpu():
    """The real gate, on the CPU backend the tests run on."""
    from edge_based_visual_odometry_tpu.utils import device as DEV

    with pytest.raises(DEV.NoGPUError, match="cpu"):
        DEV.require_gpu()
