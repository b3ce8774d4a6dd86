"""End-to-end: synthetic KITTI-layout dataset on disk -> main_vo CLI.

Exercises io/datasets.py (KITTI iterator + pose parsing), the YAML config
path, and the full pipeline loop exactly as a user would run it.
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
def kitti_dir(tmp_path_factory):
    from PIL import Image

    from edge_based_visual_odometry_tpu.io import synthetic as S

    root = tmp_path_factory.mktemp("kitti")
    seq_dir = root / "KITTI-gray" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (seq_dir / "image_1").mkdir(parents=True)
    gt_dir = root / "KITTI-gt" / "poses"
    gt_dir.mkdir(parents=True)

    seq = S.make_sequence(n_frames=3, h=120, w=160)
    gt_lines = []
    for k, f in enumerate(seq.frames):
        Image.fromarray(f.left.astype(np.uint8)).save(
            str(seq_dir / "image_0" / f"{k:06d}.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(
            str(seq_dir / "image_1" / f"{k:06d}.png"))
        # KITTI GT is cam-to-world [R|t] row-major
        Rcw = f.R.T
        tcw = -f.R.T @ f.t
        M = np.hstack([Rcw, tcw[:, None]])
        gt_lines.append(" ".join(f"{v:.9f}" for v in M.reshape(-1)))
    (gt_dir / "00.txt").write_text("\n".join(gt_lines) + "\n")

    cfg = {
        "dataset_type": "KITTI",
        "dataset_dir": str(root),
        "sequence_name": "KITTI-gray/00",
        "output_dir": str(root / "out"),
        "gt_file_path": "KITTI-gt/poses",
        "left_camera": {"resolution": [160, 120],
                        "intrinsics": [300.0, 300.0, 80.0, 60.0],
                        "distortion_coefficients": [0, 0, 0, 0]},
        "right_camera": {"resolution": [160, 120],
                         "intrinsics": [300.0, 300.0, 80.0, 60.0],
                         "distortion_coefficients": [0, 0, 0, 0]},
        "stereo": {"R21": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                   "T21": [-0.12, 0.0, 0.0]},
    }
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return root, cfg_path, seq


def test_kitti_iterator_reads_frames_and_gt(kitti_dir):
    from edge_based_visual_odometry_tpu.io import datasets

    root, cfg_path, seq = kitti_dir
    samples = list(datasets.make_iterator(
        "KITTI", str(root), "KITTI-gray/00", "KITTI-gt/poses"))
    assert len(samples) == 3
    s0 = samples[0]
    assert s0.left.shape == (120, 160)
    assert s0.gt_R is not None
    # GT line is cam->world; frame 0 pose is identity in the renderer
    np.testing.assert_allclose(s0.gt_R, np.eye(3), atol=1e-6)


def test_main_vo_cli_end_to_end(kitti_dir):
    root, cfg_path, seq = kitti_dir
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "main_vo.py"),
         "-c", str(cfg_path), "--max_frames", "3", "--max_edges", "1024"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "processed 3 frames" in out.stdout
    assert os.path.exists(str(root / "out" / "trajectory_tum.txt"))
    metrics_path = str(root / "out" / "metrics.json")
    assert os.path.exists(metrics_path), out.stdout[-2000:]
    m = json.load(open(metrics_path))
    assert m["frames"] == 3
    assert m["ate_rmse"] < 0.2


def test_main_vo_cli_dump_files(kitti_dir):
    """--dump_stereo_pairs/--dump_quads write the reference's per-frame
    file formats (Stereo_Matches.cpp:1656-1699, Temporal_Matches.cpp:
    1066-1112) from the production loop."""
    root, cfg_path, seq = kitti_dir
    out_dir = str(root / "out_dump")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "main_vo.py"),
         "-c", str(cfg_path), "--max_frames", "2", "--max_edges", "1024",
         "--output_dir", out_dir,
         "--dump_stereo_pairs", "--dump_quads",
         "--record_filter_distributions"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    for k in range(2):
        p = os.path.join(out_dir,
                         f"finalized_stereo_edge_pairs_frame_{k}.txt")
        assert os.path.exists(p)
        lines = open(p).read().splitlines()
        assert len(lines) > 1          # header + >=1 pair
        assert len(lines[1].split()) == 16
    q = os.path.join(out_dir, "quads_frame_1.txt")
    assert os.path.exists(q)
    qlines = open(q).read().splitlines()
    assert qlines[0].startswith("# keyframe 0")
    assert len(qlines) > 2
    assert len(qlines[2].split(",")) == 8
    # filter/ambiguity distributions (reference RECORD_FILTER_DISTRIBUTIONS
    # formats, Stereo_Matches.cpp:421-489)
    for k in range(2):
        fd = os.path.join(out_dir, f"sift_distance_frame_{k}.txt")
        assert os.path.exists(fd)
        fdl = open(fd).read().splitlines()
        assert fdl[2] == "filter_value\tis_GT"
        assert len(fdl) > 3
        assert len(fdl[3].split("\t")) == 2
        amb = os.path.join(out_dir, f"ambiguity_sift_frame_{k}.txt")
        assert os.path.exists(amb)
        al = open(amb).read().splitlines()
        assert al[2] == "num_candidates"
        assert len(al) > 3


def test_main_vo_cli_checkpoint_resume(kitti_dir):
    """--checkpoint_dir: run 2 of 3 frames, then resume and finish; the
    resumed run must skip processed frames and produce the full
    trajectory (utils/checkpoint.py wired into the production CLI)."""
    root, cfg_path, seq = kitti_dir
    out_dir = str(root / "out_ckpt")
    ck_dir = str(root / "ckpt")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    base = [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                         "main_vo.py"),
            "-c", str(cfg_path), "--max_edges", "1024",
            "--output_dir", out_dir, "--checkpoint_dir", ck_dir,
            "--checkpoint_every", "1"]
    out = subprocess.run(base + ["--max_frames", "2"],
                         capture_output=True, text=True, timeout=1500,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert os.path.exists(os.path.join(ck_dir, "state.npz"))

    out2 = subprocess.run(base, capture_output=True, text=True,
                          timeout=1500, env=env)
    assert out2.returncode == 0, out2.stderr[-3000:]
    assert "resumed from checkpoint at frame 2" in out2.stdout
    assert "frame 2:" in out2.stdout          # only the third frame ran
    assert "frame 1:" not in out2.stdout
    traj = open(os.path.join(out_dir, "trajectory_tum.txt")).read()
    assert len([l for l in traj.splitlines() if l.strip()]) == 3
    m = json.load(open(os.path.join(out_dir, "metrics.json")))
    assert m["frames"] == 3
    assert m["ate_rmse"] < 0.2


@pytest.mark.slow
def test_resume_with_decode_failure_no_desync(kitti_dir, tmp_path):
    """Checkpoint resume keyed on FILE position: a bad image file in the
    middle of the sequence must not desync the restart point (old code
    skipped `start` FILES equal to the PROCESSED-frame count, re-running
    the last good frame and misaligning gt_traj)."""
    import shutil

    root, cfg_path, seq = kitti_dir
    # copy the tree and corrupt file 1's left image
    root2 = tmp_path / "kitti_bad"
    shutil.copytree(str(root), str(root2))
    bad = root2 / "KITTI-gray" / "00" / "image_0" / "000001.png"
    bad.write_bytes(b"not a png")
    cfg = yaml.safe_load((root2 / "cfg.yaml").read_text())
    cfg["dataset_dir"] = str(root2)
    cfg["output_dir"] = str(root2 / "out")
    cfg_path2 = root2 / "cfg.yaml"
    cfg_path2.write_text(yaml.safe_dump(cfg))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # outside the copied tree: copytree may have brought along a ckpt/
    # and out/ left by earlier tests sharing the module fixture
    ckpt = str(tmp_path / "ckpt_fresh")
    if (root2 / "ckpt").exists():
        shutil.rmtree(str(root2 / "ckpt"))
    if (root2 / "out").exists():
        shutil.rmtree(str(root2 / "out"))
    main = os.path.join(os.path.dirname(__file__), "..", "main_vo.py")

    # first run: files 0 and 2 decode (file 1 skipped) -> 2 frames;
    # stop after them via --max_frames 2
    r1 = subprocess.run(
        [sys.executable, main, "-c", str(cfg_path2), "--max_frames", "2",
         "--max_edges", "1024", "--checkpoint_dir", ckpt, "--no_prefetch"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert r1.returncode == 0, r1.stderr[-3000:]
    assert "processed 2 frames" in r1.stdout
    cs = np.load(os.path.join(ckpt, "cli_state.npz"))
    assert int(cs["file_pos"]) == 3      # files 0..2 consumed, not 2
    assert cs["gt_R"].shape[0] == 2      # bad file's GT not collected

    # resume: no files left -> nothing re-processed, no duplicates
    r2 = subprocess.run(
        [sys.executable, main, "-c", str(cfg_path2), "--max_edges", "1024",
         "--checkpoint_dir", ckpt, "--no_prefetch"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "resumed from checkpoint at frame 2 (file 3)" in r2.stdout
    assert "processed 2 frames" in r2.stdout   # still 2 - no re-run
    # trajectory has exactly 2 entries (file 2 NOT processed twice)
    traj = open(str(root2 / "out" / "trajectory_tum.txt")).readlines()
    assert len(traj) == 2


@pytest.mark.slow
def test_resume_legacy_checkpoint_without_cli_state(kitti_dir, tmp_path):
    """A checkpoint without cli_state.npz (pre-file_idx format) resumes
    via the decode-all + skip-by-decoded-count fallback: no frame is
    re-processed and GT realigns from the decoded prefix."""
    import shutil

    root, cfg_path, seq = kitti_dir
    root3 = tmp_path / "kitti_legacy"
    shutil.copytree(str(root), str(root3))
    for d in ("ckpt", "out"):
        if (root3 / d).exists():
            shutil.rmtree(str(root3 / d))
    cfg = yaml.safe_load((root3 / "cfg.yaml").read_text())
    cfg["dataset_dir"] = str(root3)
    cfg["output_dir"] = str(root3 / "out")
    (root3 / "cfg.yaml").write_text(yaml.safe_dump(cfg))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    ckpt = str(tmp_path / "ckpt_legacy")
    main = os.path.join(os.path.dirname(__file__), "..", "main_vo.py")

    r1 = subprocess.run(
        [sys.executable, main, "-c", str(root3 / "cfg.yaml"),
         "--max_frames", "2", "--max_edges", "1024",
         "--checkpoint_dir", ckpt, "--no_prefetch"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert r1.returncode == 0, r1.stderr[-3000:]
    os.remove(os.path.join(ckpt, "cli_state.npz"))   # simulate legacy

    r2 = subprocess.run(
        [sys.executable, main, "-c", str(root3 / "cfg.yaml"),
         "--max_edges", "1024", "--checkpoint_dir", ckpt, "--no_prefetch"],
        capture_output=True, text=True, timeout=1500, env=env)
    assert r2.returncode == 0, r2.stderr[-3000:]
    assert "resumed from checkpoint at frame 2" in r2.stdout
    assert "legacy checkpoint" in r2.stdout
    assert "processed 3 frames" in r2.stdout         # one new frame only
    traj = open(str(root3 / "out" / "trajectory_tum.txt")).readlines()
    assert len(traj) == 3
    m = json.load(open(str(root3 / "out" / "metrics.json")))
    assert m["frames_processed"] == 1                # not inflated
    assert m["ate_rmse"] < 0.2                       # GT realigned
