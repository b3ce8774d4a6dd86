"""REAL-IMAGE end-to-end parity vs the actual reference binary.

Round-4 verdict item 7: the real KITTI/EuRoC/ETH3D datasets cannot be
fetched in this environment (zero egress - documented in
docs/REAL_DATA.md), so this is the prescribed stand-in: a fixture whose
TEXTURE is a real photograph (scikit-learn's china.jpg, an actual camera
image shipped in the environment) warped over the synthetic multi-plane
geometry with exact GT disparity/pose. Unlike the analytic tanh-ridge
texture, the images carry real edge statistics: vegetation clutter,
low-contrast regions, JPEG-era texture, curved boundaries.

Both binaries (the compiled, unmodified reference and our CLI) run the
SAME on-disk fixture; assertions mirror tests/test_ref_binary_e2e.py's
stage-table/pose parity at the same tolerances.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import tests.test_ref_binary_e2e as E2E

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def ref_binary():
    if not E2E._have_toolchain():
        pytest.skip("reference tree or C++ toolchain unavailable")
    if not os.path.exists(E2E.REF_BIN):
        r = subprocess.run(
            [os.path.join(E2E.REF_BUILD, "build_reference.sh")],
            capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            pytest.skip(f"reference build failed: {r.stderr[-1500:]}")
    return E2E.REF_BIN


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    """Same ETH3D-stereo tree as the analytic harness but with the
    real-photograph texture (io/synthetic.make_sequence texture='china')."""
    import yaml
    from PIL import Image

    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.io.pfm import write_pfm

    root = tmp_path_factory.mktemp("ref_e2e_real")
    seq_root = root / "seqA"
    seq = S.make_sequence(n_frames=2, h=120, w=160, texture="china")
    for k, f in enumerate(seq.frames):
        pair = seq_root / "stereo_pairs" / f"pair_{k}"
        pair.mkdir(parents=True)
        Image.fromarray(f.left.astype(np.uint8)).save(str(pair / "im0.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(str(pair / "im1.png"))
        write_pfm(str(pair / "disp0GT.pfm"), f.disparity.astype(np.float32))
        m = Image.fromarray(np.full((120, 160), 255, np.uint8))
        m.save(str(pair / "mask0nocc.png"))
        m.save(str(pair / "mask1nocc.png"))
        qw, qx, qy, qz = E2E._quat_from_R(np.asarray(f.R, np.float64))
        t = np.asarray(f.t, np.float64)
        (pair / "images.txt").write_text(
            "# COLMAP-style image list\n"
            f"1 {qw} {qx} {qy} {qz} {t[0]} {t[1]} {t[2]} 0 im0.png\n"
            "0.0 0.0 -1\n")

    rig = seq.rig
    K = np.asarray(rig.left.K)
    cfg = {
        "dataset_type": "ETH3D_stereo",
        "dataset_dir": str(root),
        "sequence_name": "seqA",
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
                   "T21": [float(np.asarray(rig.T21)[0]), 0.0, 0.0]},
    }
    (root / "out").mkdir()
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    f0, f1 = seq.frames
    R_rel = np.asarray(f1.R) @ np.asarray(f0.R).T
    return root, cfg_path, R_rel


@pytest.fixture(scope="module")
def ref_run(ref_binary, fixture_tree):
    root, cfg_path, _ = fixture_tree
    r = subprocess.run([ref_binary, "-c", str(cfg_path)],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-500:]
    return E2E._parse_ref_log(r.stdout)


@pytest.fixture(scope="module")
def our_run(fixture_tree):
    root, cfg_path, _ = fixture_tree
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "main_vo.py"),
         # real-photo texture yields ~5.1k edges at 120x160 (0.27/px -
         # 5x production density; real close-up texture is dense). The
         # reference stores candidates unboundedly, so the fixed windows
         # must be sized for the measured ambiguity (~970 candidates in
         # the radius-30 eval window): this is the "denser scene"
         # capacity story - density is absorbed by configuration, not
         # silently truncated.
         "-c", str(cfg_path), "--max_edges", "8192", "--use_gt_pose",
         "--set", "max_mates=8192",
         "--set", "quad_gather_slots=2048",
         "--set", "max_quad_candidates=64",
         "--output_dir", str(root / "out_ours")],
        capture_output=True, text=True, timeout=1500, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return E2E._parse_our_log(r.stdout)


def test_toed_edge_counts_match_reference(ref_run, our_run):
    """Real-image edge field: same TOED counts within 1%."""
    assert len(ref_run["edges"]) == 4 and len(our_run["edges"]) == 4
    for ours, ref in zip(our_run["edges"], ref_run["edges"]):
        assert abs(ours - ref) <= 0.01 * ref, (our_run["edges"],
                                               ref_run["edges"])


def test_stereo_stage_table_matches_reference(ref_run, our_run):
    """Same stage-recall tolerances as the analytic-texture harness."""
    checked = 0
    for ours_name, ref_name in E2E.STEREO_MAP:
        if ours_name not in our_run["stereo"] or \
                ref_name not in ref_run["stages"]:
            continue
        o_rec, o_prec, o_amb = our_run["stereo"][ours_name]
        r_rec, r_prec, r_amb = ref_run["stages"][ref_name]
        assert o_rec >= r_rec - 0.03, (ours_name, o_rec, r_rec)
        # one-sided: on this 5x-density fixture our exact-x-range banded
        # gather legitimately EXCEEDS the reference's precision at the
        # early stages (the reference scans a cell superset,
        # Dataset.h:69-113); only a precision DEFICIT is a parity bug
        assert o_prec >= r_prec - 0.08, (ours_name, o_prec, r_prec)
        checked += 1
    assert checked >= 6, f"only {checked} comparable stages found"


def test_temporal_stage_table_matches_reference(ref_run, our_run):
    if not ref_run["temporal"] or not our_run["temporal"]:
        pytest.skip("temporal tables missing from one side")
    checked = 0
    for ours_name, ref_name, tol in E2E.TEMPORAL_MAP:
        ours = our_run["temporal"].get(ours_name)
        ref = ref_run["temporal"].get(ref_name)
        if ours is None or ref is None:
            continue
        assert ours[0] >= ref[0] - tol, (ours_name, ours, ref)
        checked += 1
    assert checked >= 6, f"only {checked} comparable temporal stages"


def test_pose_quality_matches_reference(ref_run, our_run, fixture_tree):
    root, cfg_path, R_rel_gt = fixture_tree
    assert ref_run["inlier_ratio"] is not None
    assert our_run["inlier_ratio"] is not None
    assert our_run["inlier_ratio"] >= ref_run["inlier_ratio"] - 0.15
    if ref_run["R_est"] is not None:
        ref_err = E2E._rot_angle_deg(ref_run["R_est"] @ R_rel_gt.T)
        assert ref_err < 5.0, ref_err
    import json
    mpath = os.path.join(str(root), "out_ours", "metrics.json")
    if os.path.exists(mpath):
        m = json.load(open(mpath))
        if m.get("ate_rmse") is not None:
            assert m["ate_rmse"] < 0.1, m
