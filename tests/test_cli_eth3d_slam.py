"""End-to-end: synthetic ETH3D-SLAM dataset on disk -> main_vo CLI.

Production (no GT disparity) path through the TUM-style layout: rgb.txt
lists the RIGHT camera, rgb2/ holds the LEFT (Stereo_Iterator.cpp:441-443),
groundtruth.txt is TUM cam-to-world with the quaternion w LAST. With this
test every one of the 4 dataset formats has a CLI e2e test.
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
def eth3d_slam_cli_dir(tmp_path_factory):
    from PIL import Image

    from edge_based_visual_odometry_tpu import geometry as geom
    from edge_based_visual_odometry_tpu.io import synthetic as S

    root = tmp_path_factory.mktemp("eth3d_slam_cli")
    seq_dir = root / "cable_2"
    (seq_dir / "rgb").mkdir(parents=True)
    (seq_dir / "rgb2").mkdir(parents=True)
    seq = S.make_sequence(n_frames=3, h=120, w=160)
    rgb_rows = ["# timestamp filename"]
    gt_rows = ["# TUM ground truth: ts tx ty tz qx qy qz qw"]
    for k, f in enumerate(seq.frames):
        name = f"{k:04d}.png"
        # rgb.txt -> RIGHT camera; rgb2/ -> LEFT
        Image.fromarray(np.asarray(f.right, np.uint8)).save(
            str(seq_dir / "rgb" / name))
        Image.fromarray(np.asarray(f.left, np.uint8)).save(
            str(seq_dir / "rgb2" / name))
        ts = 0.1 * (k + 1)
        rgb_rows.append(f"{ts:.6f} rgb/{name}")
        R_cw = np.asarray(f.R).T
        t_cw = -R_cw @ np.asarray(f.t)
        qw, qx, qy, qz = geom.R_to_quat(R_cw)
        gt_rows.append(f"{ts:.6f} {t_cw[0]} {t_cw[1]} {t_cw[2]} "
                       f"{qx} {qy} {qz} {qw}")
    (seq_dir / "rgb.txt").write_text("\n".join(rgb_rows) + "\n")
    (seq_dir / "groundtruth.txt").write_text("\n".join(gt_rows) + "\n")

    cam = seq.rig.left
    cfg = {
        "dataset_type": "ETH3D_slam",
        "dataset_dir": str(root),
        "sequence_name": "cable_2",
        "output_dir": str(root / "out"),
        "left_camera": {"resolution": [160, 120],
                        "intrinsics": [float(cam.fx), float(cam.fy),
                                       float(cam.cx), float(cam.cy)],
                        "distortion_coefficients": [0, 0, 0, 0]},
        "right_camera": {"resolution": [160, 120],
                         "intrinsics": [float(cam.fx), float(cam.fy),
                                        float(cam.cx), float(cam.cy)],
                         "distortion_coefficients": [0, 0, 0, 0]},
        "stereo": {"R21": np.asarray(seq.rig.R21).tolist(),
                   "T21": np.asarray(seq.rig.T21).ravel().tolist(),
                   "F21": np.asarray(seq.rig.F21).tolist()},
    }
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return root, cfg_path


def test_main_vo_cli_eth3d_slam(eth3d_slam_cli_dir):
    root, cfg_path = eth3d_slam_cli_dir
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "main_vo.py", "-c", str(cfg_path),
         "--max_edges", "2048"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "frame 2:" in out.stdout
    # cascade loaded: quads and a credible inlier ratio on frame 1+
    assert "quads" in out.stdout

    m = json.load(open(root / "out" / "metrics.json"))
    assert m["frames"] == 3
    assert m["ate_rmse"] < 0.2, m["ate_rmse"]
