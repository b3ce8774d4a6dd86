"""End-to-end stereo cascade on a synthetic scene with exact GT disparity.

The automated analog of the reference's in-pipeline GT-supervised evaluation on
ETH3D delivery_area (SURVEY.md §4.2): stage recall/precision become
automated assertions.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from edge_based_visual_odometry_tpu.config import VOConfig
from edge_based_visual_odometry_tpu.io import synthetic as S
from edge_based_visual_odometry_tpu.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu.models.types import FrameData, RigArrays
from edge_based_visual_odometry_tpu.ops import image as IMG
from edge_based_visual_odometry_tpu.ops import toed


CFG = VOConfig(max_edges=4096, max_candidates=16, gather_slots=160,
               max_mates=3072, max_refine_pairs=8192)


def make_frame_data(left, right):
    lgx, lgy = IMG.sobel_gradients(jnp.asarray(left))
    rgx, rgy = IMG.sobel_gradients(jnp.asarray(right))
    return FrameData(left=jnp.asarray(left), right=jnp.asarray(right),
                     left_gx=lgx, left_gy=lgy, right_gx=rgx, right_gy=rgy)


@pytest.fixture(scope="module")
def scene():
    seq = S.make_sequence(n_frames=1, h=240, w=320)
    f = seq.frames[0]
    led = toed.detect_edges(jnp.asarray(f.left), max_edges=CFG.max_edges)
    red = toed.detect_edges(jnp.asarray(f.right), max_edges=CFG.max_edges)
    frame = make_frame_data(f.left, f.right)
    rig = RigArrays.from_rig(seq.rig)
    return seq, f, led, red, frame, rig


def test_edges_found(scene):
    _, _, led, red, _, _ = scene
    assert int(led.count) > 300
    assert int(red.count) > 300


@pytest.mark.heavy
def test_stereo_cascade_gt_metrics(scene):
    seq, f, led, red, frame, rig = scene
    mates, state, metrics = SM.match_stereo(
        led, red, frame, rig, CFG, disparity_map=jnp.asarray(f.disparity))
    metrics = np.asarray(metrics)
    stages = dict(zip(SM.STAGE_NAMES, metrics))

    # stage 1 recall: nearly every veridical match is within the epipolar
    # band (rows were prefiltered to have veridical candidates)
    assert stages["Epipolar Proximity"][0] > 0.9
    # precision improves monotonically through the gating stages
    assert stages["NCC"][1] > stages["Epipolar Proximity"][1]
    # final: one candidate per surviving row, high precision
    final = stages["Final"]
    assert final[0] > 0.9, f"final recall too low: {final}"
    assert final[1] > 0.9, f"final precision too low: {final}"
    assert final[3] <= 1.0 + 1e-6  # ambiguity after Best is 1

    # mates: enough survivors, small disparity error for TPs
    n = int(mates.count)
    assert n > 100
    v = np.asarray(mates.valid)
    est_disp = np.asarray(mates.left_x - mates.right_x)[v]
    gt_disp = np.asarray(mates.left_x - mates.gt_x)[v]
    tp = np.asarray(mates.is_tp)[v]
    assert tp.mean() > 0.9
    err = np.abs(est_disp[tp] - gt_disp[tp])
    assert np.median(err) < 0.3


@pytest.mark.heavy
def test_stereo_cascade_runs_without_gt(scene):
    seq, f, led, red, frame, rig = scene
    mates, state, metrics = SM.match_stereo(led, red, frame, rig, CFG,
                                            disparity_map=None)
    n = int(mates.count)
    assert n > 100
    # production-path 3D points: positive depth in front of the camera
    v = np.asarray(mates.valid)
    z = np.asarray(mates.gamma)[v, 2]
    assert (z > 0).mean() > 0.95
    assert np.median(np.abs(z - 4.0)) < 1.0  # plane is ~4 m away


@pytest.mark.heavy
def test_stereo_matches_against_gt_without_supervision(scene):
    """Without the GT prefilter, the matcher must still find mostly-correct
    disparities (compare to the analytic disparity map post hoc)."""
    seq, f, led, red, frame, rig = scene
    mates, _, _ = SM.match_stereo(led, red, frame, rig, CFG)
    v = np.asarray(mates.valid)
    lx = np.asarray(mates.left_x)[v]
    ly = np.asarray(mates.left_y)[v]
    est = lx - np.asarray(mates.right_x)[v]
    gt = f.disparity[np.round(ly).astype(int), np.round(lx).astype(int)]
    frac_good = (np.abs(est - gt) < 1.0).mean()
    assert frac_good > 0.7, f"only {frac_good:.2%} within 1 px of GT disparity"


def test_bnb_keep_matches_sorted_reference():
    """The sort-free BNB reduction must equal the reference's
    sorted-streak semantics (Stereo_Matches.cpp:789-862) on random data,
    including negative NCC scores, ties, and sparse masks."""
    import numpy as np

    from edge_based_visual_odometry_tpu.models.stereo_matcher import _bnb_keep

    def sorted_streak(scores, mask, thresh, higher_better):
        out = np.zeros_like(mask)
        for r in range(scores.shape[0]):
            idx = [j for j in range(scores.shape[1]) if mask[r, j]]
            if len(idx) < 2:
                out[r] = mask[r]
                continue
            idx.sort(key=lambda j: -scores[r, j] if higher_better
                     else scores[r, j])
            best = scores[r, idx[0]]
            out[r, idx[0]] = True
            for j in idx[1:]:
                ratio = (scores[r, j] / best) if higher_better \
                    else (best / scores[r, j])
                if best != 0.0 and ratio >= thresh:
                    out[r, j] = True
                else:
                    break
        return out

    rng = np.random.default_rng(7)
    for higher in (True, False):
        for _ in range(5):
            s = rng.uniform(-1 if higher else 0.01, 1 if higher else 600,
                            (64, 12)).astype(np.float32)
            s[rng.random((64, 12)) < 0.1] = 0.5   # inject ties
            m = rng.random((64, 12)) < 0.7
            ref = sorted_streak(s, m, 0.8, higher)
            got = np.asarray(_bnb_keep(jnp.asarray(s), jnp.asarray(m),
                                       0.8, higher))
            np.testing.assert_array_equal(got, ref)


@pytest.mark.heavy
@pytest.mark.parametrize("flat_layout", ["flat", "flat4", "flat5"])
def test_gate_layouts_equal(flat_layout):
    """Every flat (active-pair list) layout variant - including the
    single-stage arms flat4/flat5, selectable in production via --set
    gate_layout=... - must produce identical cascade results to the dense
    ((N, C) row-chunk) oracle."""
    import dataclasses

    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    seq = S.make_sequence(n_frames=1, h=240, w=320)
    outs = {}
    for layout in (flat_layout, "dense"):
        cfg = dataclasses.replace(CFG, gate_layout=layout)
        step = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
        outs[layout] = step(jnp.asarray(seq.frames[0].left),
                            jnp.asarray(seq.frames[0].right))
    a, b = outs[flat_layout], outs["dense"]
    assert int(a.mates.count) == int(b.mates.count) > 100
    n = int(a.mates.count)
    np.testing.assert_allclose(np.asarray(a.mates.left_x)[:n],
                               np.asarray(b.mates.left_x)[:n])
    np.testing.assert_allclose(np.asarray(a.mates.right_x)[:n],
                               np.asarray(b.mates.right_x)[:n], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.stereo_metrics)[:, :2],
                                  np.asarray(b.stereo_metrics)[:, :2])


def test_flatten_active_overflow_targets_distinct():
    """Compaction scatter safety when actives exceed capacity: every
    scatter target must be distinct even for dropped entries
    (unique_indices=True is a promise; a collision is undefined behaviour
    that a backend compiler has miscompiled). Regression for the code-review finding: overflow
    cumsum positions used to collide with inactive OOB targets."""
    N, C, cap = 8, 8, 16
    cmask = jnp.ones((N, C), bool)          # 64 actives >> cap=16
    # reproduce the target computation
    flat = cmask.reshape(-1)
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1
    lin = jnp.arange(N * C, dtype=jnp.int32)
    tgt = np.asarray(jnp.where(flat, pos, N * C + lin))
    assert len(np.unique(tgt)) == tgt.size
    # and the public function keeps exactly the first cap pairs
    rows, slots, fmask = SM._flatten_active(cmask, cap)
    assert int(fmask.sum()) == cap
    got = {(int(r), int(s)) for r, s, m in
           zip(np.asarray(rows), np.asarray(slots), np.asarray(fmask)) if m}
    assert got == {(i // C, i % C) for i in range(cap)}

    # mixed actives/inactives with overflow: distinctness must still hold
    rng = np.random.default_rng(0)
    cm2 = jnp.asarray(rng.random((N, C)) < 0.7)
    flat2 = cm2.reshape(-1)
    pos2 = jnp.cumsum(flat2.astype(jnp.int32)) - 1
    tgt2 = np.asarray(jnp.where(flat2, pos2, N * C + lin))
    assert len(np.unique(tgt2)) == tgt2.size


@pytest.mark.heavy
@pytest.mark.parametrize("flat_layout", ["flat", "flat4", "flat5"])
def test_gate_layouts_equal_under_budget_overflow(flat_layout):
    """With max_gate_pairs far below the live pair count, each flat layout
    variant must still match the dense layout's FINAL mates (overflow pairs
    pass the desc/NCC gates unscored at threshold level; regression for the
    silent-kill finding) - the cascade's later exact stages (GN,
    clustering, best-pick) then dominate the outcome."""
    import dataclasses

    from edge_based_visual_odometry_tpu.io import synthetic as S
    from edge_based_visual_odometry_tpu.models import pipeline as PL

    seq = S.make_sequence(n_frames=1, h=240, w=320)
    outs = {}
    for layout in (flat_layout, "dense"):
        cfg = dataclasses.replace(CFG, gate_layout=layout,
                                  max_gate_pairs=2048)   # << live pairs
        step = PL.build_stereo_step(seq.rig, cfg, has_gt=False)
        outs[layout] = step(jnp.asarray(seq.frames[0].left),
                            jnp.asarray(seq.frames[0].right))
    a, b = outs[flat_layout], outs["dense"]
    na, nb = int(a.mates.count), int(b.mates.count)
    assert na > 100
    # overflow pairs are unscored in flat (kept at threshold) while dense
    # scores everything, so exact equality is impossible; but the flat
    # cascade must not LOSE mates relative to dense (the old behavior
    # killed every overflow pair outright)
    assert na >= 0.9 * nb, (na, nb)
