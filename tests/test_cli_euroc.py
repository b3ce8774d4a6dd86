"""End-to-end: synthetic EuRoC-layout dataset on disk -> main_vo CLI.

Completes the per-format CLI coverage (KITTI: test_cli_dataset.py,
ETH3D-stereo: test_ref_binary_e2e.py): EuRoC exercises the CSV pair
list, nearest-timestamp GT alignment and the body->cam GT chain
(reference Stereo_Iterator.cpp:484-558) through the production CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

pytestmark = pytest.mark.heavy  # multi-second jitted integration programs


@pytest.fixture(scope="module")
def euroc_tree(tmp_path_factory):
    from PIL import Image

    from edge_based_visual_odometry_tpu.io import synthetic as S

    root = tmp_path_factory.mktemp("euroc_cli")
    base = root / "MH_01_easy" / "mav0"
    for cam in ("cam0", "cam1"):
        (base / cam / "data").mkdir(parents=True)
    (base / "state_groundtruth_estimate0").mkdir(parents=True)

    seq = S.make_sequence(n_frames=3, h=120, w=160)
    ts_list = [1403636579763555584 + int(5e7) * k for k in range(3)]
    rows = ["#timestamp [ns],filename"]
    gt_rows = ["#timestamp, p_RS_R_x [m], ..."]
    for k, (f, ts) in enumerate(zip(seq.frames, ts_list)):
        Image.fromarray(f.left.astype(np.uint8)).save(
            str(base / "cam0" / "data" / f"{ts}.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(
            str(base / "cam1" / "data" / f"{ts}.png"))
        rows.append(f"{ts},{ts}.png")
        # EuRoC GT is body->world; with identity frame2body the body IS
        # the left camera: R_wb = f.R.T, p = camera center
        R_wb = np.asarray(f.R, np.float64).T
        p = -R_wb @ np.asarray(f.t, np.float64)
        qw = np.sqrt(max(0, 1 + np.trace(R_wb))) / 2
        qx = (R_wb[2, 1] - R_wb[1, 2]) / (4 * qw)
        qy = (R_wb[0, 2] - R_wb[2, 0]) / (4 * qw)
        qz = (R_wb[1, 0] - R_wb[0, 1]) / (4 * qw)
        gt_rows.append(",".join(
            [str(ts)] + [f"{v:.9f}" for v in p]
            + [f"{v:.9f}" for v in (qw, qx, qy, qz)] + ["0.0"] * 9))
    (base / "cam0" / "data.csv").write_text("\n".join(rows) + "\n")
    (base / "state_groundtruth_estimate0" / "data.csv").write_text(
        "\n".join(gt_rows) + "\n")

    K = np.asarray(seq.rig.left.K)
    cfg = {
        "dataset_type": "EuRoC",
        "dataset_dir": str(root),
        "sequence_name": "MH_01_easy",
        "output_dir": str(root / "out"),
        "left_camera": {"resolution": [160, 120],
                        "intrinsics": [float(K[0, 0]), float(K[1, 1]),
                                       float(K[0, 2]), float(K[1, 2])],
                        "distortion_coefficients": [0, 0, 0, 0]},
        "right_camera": {"resolution": [160, 120],
                         "intrinsics": [float(K[0, 0]), float(K[1, 1]),
                                        float(K[0, 2]), float(K[1, 2])],
                         "distortion_coefficients": [0, 0, 0, 0]},
        "stereo": {"R21": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.0, 0.0, 1.0]],
                   "T21": [float(np.asarray(seq.rig.T21)[0]), 0.0, 0.0]},
        "frame_to_body": {
            "rotation": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
            "translation": [0.0, 0.0, 0.0]},
    }
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return root, cfg_path


def test_main_vo_cli_euroc_end_to_end(euroc_tree):
    root, cfg_path = euroc_tree
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "main_vo.py"),
         "-c", str(cfg_path), "--max_edges", "1024"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "processed 3 frames" in out.stdout
    m = json.load(open(str(root / "out" / "metrics.json")))
    assert m["frames"] == 3
    assert m["ate_rmse"] < 0.2, out.stdout[-1500:]
