"""End-to-end: synthetic ETH3D-stereo dataset on disk -> main_vo CLI.

The only dataset format with GT disparity (src/Dataset.cpp:126-129), so
this exercises the full GT-supervised evaluation path exactly as a user
would run it: veridical-set construction from disp0GT.pfm, occlusion
masks, per-stage recall/precision tables, and metrics.json with ATE.
Complements tests/test_cli_dataset.py (KITTI + EuRoC, production path)
and tests/test_dataset_iterators.py (format parsing only).
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
def eth3d_cli_dir(tmp_path_factory):
    from PIL import Image

    from edge_based_visual_odometry_tpu import geometry as geom
    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.io.pfm import write_pfm

    root = tmp_path_factory.mktemp("eth3d_cli")
    seq_dir = root / "delivery_area"
    seq = S.make_sequence(n_frames=3, h=120, w=160)
    for k, f in enumerate(seq.frames):
        pair = seq_dir / "stereo_pairs" / f"pair_{k}"
        pair.mkdir(parents=True)
        Image.fromarray(np.asarray(f.left, np.uint8)).save(
            str(pair / "im0.png"))
        Image.fromarray(np.asarray(f.right, np.uint8)).save(
            str(pair / "im1.png"))
        write_pfm(str(pair / "disp0GT.pfm"),
                  np.asarray(f.disparity, np.float32))
        Image.fromarray(np.full((120, 160), 255, np.uint8)).save(
            str(pair / "mask0nocc.png"))
        Image.fromarray(np.full((120, 160), 255, np.uint8)).save(
            str(pair / "mask1nocc.png"))
        # COLMAP images.txt stores WORLD->CAM; the renderer's (R, t) is
        # world->cam already
        qw, qx, qy, qz = geom.R_to_quat(np.asarray(f.R))
        t = np.asarray(f.t, np.float64)
        (pair / "images.txt").write_text(
            "# COLMAP image list\n"
            f"1 {qw} {qx} {qy} {qz} {t[0]} {t[1]} {t[2]} 0 im0.png\n"
            "0.0 0.0 -1\n")

    cam = seq.rig.left
    cfg = {
        "dataset_type": "ETH3D_stereo",
        "dataset_dir": str(root),
        "sequence_name": "delivery_area",
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


def test_main_vo_cli_eth3d_gt_supervised(eth3d_cli_dir):
    root, cfg_path = eth3d_cli_dir
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "main_vo.py", "-c", str(cfg_path),
         "--max_edges", "2048"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    # GT mode prints the reference-format per-stage tables
    assert "Recall" in out.stdout and "Epipolar Proximity" in out.stdout
    # frames processed with live cascade
    assert "frame 2:" in out.stdout

    m = json.load(open(root / "out" / "metrics.json"))
    assert m["frames"] == 3
    assert m["ate_rmse"] < 0.2, m["ate_rmse"]
    assert os.path.exists(root / "out" / "trajectory_tum.txt")

    # parse the printed reference-format table: veridical supervision on a
    # clean synthetic scene must show a working Final stage
    final_rows = [ln for ln in out.stdout.splitlines()
                  if ln.strip().startswith("Final")]
    assert final_rows, out.stdout[-3000:]
    recall, precision = (float(v.strip())
                         for v in final_rows[0].split("|")[1:3])
    assert recall > 0.5, final_rows[0]
    assert precision > 0.5, final_rows[0]
