"""Frame-level VO pipeline: the jitted equivalent of the reference FSM.

The reference Pipeline (src/Pipeline.cpp:34-59) is a sequential state
machine IMG_PREPARATION -> STEREO -> TEMPORAL -> POSE driven per frame.
Here each transition group is one jit-compiled device program:

  `stereo_step`    = undistort + gradients + TOED x2 + stereo cascade
                     (prepare_Stereo_Images :64-107 +
                      get_Stereo_Edge_Correspondences :109-145)
  `temporal_step`  = quad cascade + RANSAC pose
                     (get_Temporal_Edge_Correspondences :147-190 +
                      get_Pose_From_Quad_Pairs :192-223)

Host code only decodes images and carries the keyframe pytree between
calls; there are no per-stage host syncs.

Keyframing: the reference keeps exactly frame 0 as keyframe
(src/Pipeline.cpp:133-137). We default to the same behavior and add an
optional re-keyframing policy (new capability; see `VOPipeline.run_frame`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from edge_based_visual_odometry_tpu import geometry as geom
from edge_based_visual_odometry_tpu.config import StereoRig, VOConfig
from edge_based_visual_odometry_tpu.models import motion_tracker as MT
from edge_based_visual_odometry_tpu.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu.models.types import FrameData, RigArrays, StereoMates
from edge_based_visual_odometry_tpu.ops import image as IMG
from edge_based_visual_odometry_tpu.ops import toed


class FrameResult(NamedTuple):
    frame: FrameData
    mates: StereoMates
    stereo_metrics: jnp.ndarray     # (n_stages, 4)
    n_left_edges: jnp.ndarray
    n_right_edges: jnp.ndarray
    # filter/ambiguity distributions (reference RECORD_FILTER_DISTRIBUTIONS
    # surface); None unless the step was built with record_distributions
    # (None, not {}: a shared mutable class-level default dict would alias
    # across every default-constructed FrameResult)
    distributions: Optional[dict] = None


class TemporalResult(NamedTuple):
    quads: TM.TemporalQuads
    temporal_metrics: jnp.ndarray   # (n_stages, 4)
    R: jnp.ndarray                  # relative pose KF -> CF
    t: jnp.ndarray
    inlier_count: jnp.ndarray
    inlier_ratio: jnp.ndarray
    n_quads: jnp.ndarray
    success: jnp.ndarray


@functools.lru_cache(maxsize=None)
def _stereo_step_jit(cfg: VOConfig, has_gt: bool,
                     record_distributions: bool, gather_ry: float,
                     need_undistort_l: bool, need_undistort_r: bool):
    """One jitted stereo-step program per STATIC configuration. The rig
    (camera matrices + distortion coefficients) enters as a jit ARGUMENT,
    not a closed-over constant: the compiled program is rig-independent
    for rigs sharing the image size / distortion flags / gather band, so
    e.g. the longseq corridor rig reuses the bench rig's cached
    executables instead of paying a full recompile per new camera. The
    lru_cache makes the reuse in-process too (a fresh @jax.jit object per
    build would re-trace)."""
    @jax.jit
    def step(left, right, rig_arrays, dist_l, dist_r,
             disparity=None, occlusion=None):
        left = left.astype(jnp.float32)
        right = right.astype(jnp.float32)
        if need_undistort_l:
            left = IMG.undistort(left, rig_arrays.K_left, dist_l)
        if need_undistort_r:
            right = IMG.undistort(right, rig_arrays.K_right, dist_r)
        # batch the two images through one detector/gradient program:
        # left/right are data-independent, and two separate calls emitted
        # two full copies of every TOED/sobel kernel (half-width each)
        both = jnp.stack([left, right])
        gxs, gys = jax.vmap(IMG.sobel_gradients)(both)
        frame = FrameData(left=left, right=right,
                          left_gx=gxs[0], left_gy=gys[0],
                          right_gx=gxs[1], right_gy=gys[1])
        eds = jax.vmap(lambda im: toed.detect_edges(
            im, kernel_size=cfg.toed_kernel_size,
            sigma=cfg.toed_sigma,
            grad_mag_min=cfg.toed_grad_mag_min,
            max_edges=cfg.max_edges,
            border=cfg.toed_border))(both)
        led = jax.tree_util.tree_map(lambda a: a[0], eds)
        red = jax.tree_util.tree_map(lambda a: a[1], eds)
        out = SM.match_stereo(
            led, red, frame, rig_arrays, cfg,
            disparity_map=disparity if has_gt else None,
            occlusion_map=occlusion if has_gt else None,
            gather_ry=gather_ry,
            record_distributions=record_distributions)
        mates, metrics = out[0], out[2]
        dists = out[3] if record_distributions else {}
        return FrameResult(frame=frame, mates=mates, stereo_metrics=metrics,
                           n_left_edges=led.count, n_right_edges=red.count,
                           distributions=dists)

    return step


def build_stereo_step(rig: StereoRig, cfg: VOConfig, has_gt: bool,
                      record_distributions: bool = False):
    """Returns jitted fn (left_u8, right_u8[, disparity]) -> FrameResult."""
    rig_arrays = RigArrays.from_rig(rig)
    # static gather band from the rig's epipolar geometry: 4 px for
    # rectified rigs, wider for verged ones (see SM.derive_gather_band)
    gather_ry = SM.derive_gather_band(rig, cfg)
    dist_l = jnp.asarray(rig.left.distortion[:4], jnp.float32)
    dist_r = jnp.asarray(rig.right.distortion[:4], jnp.float32)
    need_undistort_l = any(abs(d) > 0 for d in rig.left.distortion[:4])
    need_undistort_r = any(abs(d) > 0 for d in rig.right.distortion[:4])
    step = _stereo_step_jit(cfg, has_gt, record_distributions, gather_ry,
                            need_undistort_l, need_undistort_r)
    if has_gt:
        return lambda l, r, disparity=None, occlusion=None: step(
            l, r, rig_arrays, dist_l, dist_r, disparity, occlusion)
    # a partial, not a lambda: `.func` / `.keywords` let callers lower and
    # compile the jitted program ahead of time (memory analysis)
    return functools.partial(step, rig_arrays=rig_arrays, dist_l=dist_l,
                             dist_r=dist_r)


@functools.lru_cache(maxsize=None)
def _temporal_step_jit(cfg: VOConfig, use_gt: bool):
    """One jitted temporal-step program per static configuration; rig as
    a jit argument (see _stereo_step_jit)."""
    @jax.jit
    def step(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t, seed,
             rig_a):
        rel = geom.Pose(rel_R, rel_t)
        quads, tmetrics = TM.match_temporal(
            kf_mates, cf_mates, kf_frame, cf_frame, rel, rig_a, cfg,
            use_gt=use_gt)
        pq = MT.lift_quads(kf_mates, quads, rig_a, cfg, use_gt=use_gt)
        res = MT.estimate_pose(pq, rig_a, cfg, seed)
        return TemporalResult(
            quads=quads, temporal_metrics=tmetrics,
            R=res.R, t=res.t, inlier_count=res.inlier_count,
            inlier_ratio=res.inlier_ratio, n_quads=res.n_quads,
            success=res.success)

    return step


def build_temporal_step(rig: StereoRig, cfg: VOConfig, use_gt: bool):
    """Returns jitted fn (kf_mates, kf_frame, cf_mates, cf_frame,
    rel_R, rel_t, seed) -> TemporalResult. rel_R/rel_t: KF->CF pose used
    for quad prediction (GT in eval mode, predicted in production)."""
    rig_arrays = RigArrays.from_rig(rig)
    step = _temporal_step_jit(cfg, use_gt)
    return functools.partial(step, rig_a=rig_arrays)


@dataclasses.dataclass
class VOPipeline:
    """Host-side driver carrying keyframe state across frames
    (reference Pipeline class, include/Pipeline.h:31-198)."""

    rig: StereoRig
    cfg: VOConfig
    has_gt_disparity: bool = False
    use_gt_pose: bool = False
    # Keyframe policy. The reference keeps exactly frame 0 as keyframe
    # forever (src/Pipeline.cpp:133-137) - fine for its 2-frame research
    # runs, unusable for long sequences (the temporal search radius is
    # 30 px around the KF edge locations). Policies:
    #   "reference"   - frame 0 only (reference behavior)
    #   "every_frame" - previous frame becomes the keyframe (frame-to-frame
    #                   VO; robust default for real sequences)
    #   "adaptive"    - re-keyframe when tracking quality drops below
    #                   rekeyframe_min_inlier_ratio / rekeyframe_min_quads
    keyframe_policy: str = "every_frame"
    rekeyframe_min_inlier_ratio: float = 0.4
    rekeyframe_min_quads: int = 50
    # sliding-window BA (new capability; models/window_ba.py). 0 = off;
    # >= 2 sets the window length in keyframes. Requires a re-keyframing
    # policy ('every_frame' or 'adaptive').
    ba_window: int = 0
    # optional jax.sharding.Mesh: shards the BA landmark/observation axes
    # over the mesh (parallel/mesh.py docstring); None = single device
    ba_mesh: object = None
    # emit per-frame filter-score/ambiguity distributions in FrameResult
    # (reference RECORD_FILTER_DISTRIBUTIONS, definitions.h:61)
    record_distributions: bool = False

    def __post_init__(self):
        has_dist = (any(abs(d) > 0 for d in self.rig.left.distortion[:4])
                    or any(abs(d) > 0 for d in self.rig.right.distortion[:4]))
        self._undistort_on_host = False
        rig_for_device = self.rig
        if has_dist:
            try:
                import cv2  # noqa: F401
                import dataclasses as _dc
                self._undistort_on_host = True
                rig_for_device = _dc.replace(
                    self.rig,
                    left=_dc.replace(self.rig.left,
                                     distortion=(0.0, 0.0, 0.0, 0.0)),
                    right=_dc.replace(self.rig.right,
                                      distortion=(0.0, 0.0, 0.0, 0.0)))
            except ImportError:
                pass   # device-side undistort fallback (ops/image.py)
        self._stereo_step = build_stereo_step(
            rig_for_device, self.cfg, self.has_gt_disparity,
            record_distributions=self.record_distributions)
        self._temporal_step = build_temporal_step(
            self.rig, self.cfg, self.use_gt_pose)
        # Bootstrap program for the FIRST temporal step of a run: the
        # prediction there is identity (no velocity yet), so its error is
        # the full inter-frame motion - run that one step with the
        # reference-mode window (radius 30 around the prediction = the KF
        # location under identity) before switching to the tight
        # prediction-centered window (VOConfig.temporal_gather_mode).
        self._temporal_step_boot = self._temporal_step
        if (not self.use_gt_pose
                and self.cfg.temporal_gather_mode == "prediction"):
            import dataclasses as _dc2
            boot_cfg = _dc2.replace(
                self.cfg,
                temporal_grid_radius_prod=self.cfg.temporal_grid_radius,
                quad_gather_slots_prod=self.cfg.quad_gather_slots)
            self._temporal_step_boot = build_temporal_step(
                self.rig, boot_cfg, self.use_gt_pose)
        self._have_velocity = False   # becomes True after the first
                                      # successful temporal step
        self.wba = None
        if self.ba_window >= 2:
            # Track chaining links the PREVIOUS keyframe's mates to the
            # new keyframe through the quads of the re-keyframing frame,
            # which holds for every policy that re-keyframes ('every_frame'
            # and 'adaptive'); only the reference's frame-0-forever policy
            # never yields a second keyframe.
            if self.keyframe_policy not in ("every_frame", "adaptive"):
                # ValueError, not assert: an assert is silently skipped
                # under python -O and surfaces as a bare AssertionError
                # traceback otherwise
                raise ValueError(
                    "windowed BA (ba_window >= 2) requires a re-keyframing "
                    f"policy, got keyframe_policy={self.keyframe_policy!r}")
            from edge_based_visual_odometry_tpu.models.window_ba import (
                WindowBA, WindowBAConfig)
            self.wba = WindowBA(self.rig.left.K,
                                WindowBAConfig(window=self.ba_window),
                                mesh=self.ba_mesh)
        self.keyframe: Optional[FrameResult] = None
        self.kf_index = 0                                # frame index of the KF
        self._ba_kf_frames = []       # frame index of each BA-window keyframe
        self.kf_pose_gt: Optional[geom.Pose] = None      # world->cam GT
        self.kf_pose_est = geom.Pose.identity()          # world->cam estimate
        self.trajectory = []                             # per-frame (R, t) world->cam
        self.frame_idx = 0
        self.stereo_metrics_log = []
        self.temporal_metrics_log = []
        self.ba_info_log = []         # per-BA-solve info dicts (incl.
                                      # host_assembly_s / solve_s timings)
        self.last_rel = geom.Pose.identity()             # predicted KF->CF
        self.prev_cam_pose: Optional[geom.Pose] = None   # previous frame world->cam

    def _host_undistort(self, img, cam):
        """Undistort on the host like the reference (cv::undistort,
        src/Pipeline.cpp:78-79): full-image per-pixel resampling is a poor
        fit for the device; the host absorbs it alongside decode."""
        import cv2
        return cv2.undistort(np.asarray(img, np.float32),
                             np.asarray(cam.K),
                             np.asarray(cam.distortion[:4], np.float64))

    def run_frame(self, left_img: np.ndarray, right_img: np.ndarray,
                  disparity: Optional[np.ndarray] = None,
                  gt_pose: Optional[geom.Pose] = None,
                  occlusion: Optional[np.ndarray] = None):
        """Process one stereo frame; returns (FrameResult,
        TemporalResult | None). `occlusion`: ETH3D non-occlusion mask
        (255 = visible), used by the GT supervision path."""
        if self._undistort_on_host:
            left_img = self._host_undistort(left_img, self.rig.left)
            right_img = self._host_undistort(right_img, self.rig.right)
        if self.has_gt_disparity:
            occ = (jnp.asarray(occlusion) if occlusion is not None
                   else jnp.full_like(jnp.asarray(disparity), 255.0))
            fr = self._stereo_step(jnp.asarray(left_img),
                                   jnp.asarray(right_img),
                                   jnp.asarray(disparity), occ)
        else:
            fr = self._stereo_step(jnp.asarray(left_img),
                                   jnp.asarray(right_img))
        if self.has_gt_disparity:
            self.stereo_metrics_log.append(np.asarray(fr.stereo_metrics))

        tr = None
        if self.keyframe is None:
            self._set_keyframe(fr, gt_pose)
            self.trajectory.append(self.kf_pose_est)
            self.prev_cam_pose = self.kf_pose_est
            if self.wba is not None:
                self.wba.add_keyframe(fr.mates, self.kf_pose_est)
                self._ba_kf_frames.append(self.frame_idx)
        else:
            if self.use_gt_pose:
                rel = geom.relative_pose(self.kf_pose_gt, gt_pose)
            else:
                rel = self.last_rel    # constant-position prediction
            step = (self._temporal_step if self._have_velocity
                    else self._temporal_step_boot)
            tr = step(
                self.keyframe.mates, self.keyframe.frame,
                fr.mates, fr.frame, rel.R, rel.t,
                jnp.int32(self.cfg.ransac_seed + self.frame_idx))
            if bool(tr.success):
                self._have_velocity = True
            if self.use_gt_pose:
                self.temporal_metrics_log.append(
                    np.asarray(tr.temporal_metrics))
            rel_est = geom.Pose(tr.R, tr.t)
            cam_pose = rel_est.compose(self.kf_pose_est)
            self.trajectory.append(cam_pose)
            # constant-velocity prediction for the next frame's quad
            # search: vel = previous frame -> current frame motion. The
            # earlier identity reset made every_frame runs predict
            # zero motion, so the 30 px gather radius had to absorb the
            # full inter-frame motion.
            vel = geom.relative_pose(self.prev_cam_pose, cam_pose)
            self.prev_cam_pose = cam_pose
            if self._should_rekeyframe(tr):
                self.kf_pose_est = cam_pose
                self._set_keyframe(fr, gt_pose)
                self.last_rel = vel          # next KF->CF ~ one step
                if self.wba is not None:
                    from edge_based_visual_odometry_tpu.models.window_ba import (
                        best_links_from_quads)
                    self.wba.add_keyframe(fr.mates, cam_pose,
                                          best_links_from_quads(tr))
                    self._ba_kf_frames.append(self.frame_idx)
                    out = self.wba.run()
                    if out is not None:
                        poses, ba_info = out
                        self.ba_info_log.append(ba_info)
                        # Refresh the KEYFRAME entries of the trajectory +
                        # the current estimate. Under 'adaptive' keyframes
                        # are a sparse subset of frames, so write back at
                        # the recorded keyframe frame indices - NOT the
                        # trajectory tail (intermediate frames keep their
                        # original relative estimates).
                        # Align from the END: newest pose <-> newest
                        # recorded keyframe index. A plain zip of
                        # ks[-len(poses):] with poses mispairs when fewer
                        # indices than poses are recorded (e.g. a resumed
                        # legacy checkpoint repopulated the BA window but
                        # not the index list).
                        ks = self._ba_kf_frames
                        m = min(len(ks), len(poses))
                        for fi, p in zip(ks[-m:], poses[-m:]):
                            self.trajectory[fi] = p
                        self.kf_pose_est = poses[-1]
            else:
                self.last_rel = vel.compose(rel_est)
        self.frame_idx += 1
        return fr, tr

    def _should_rekeyframe(self, tr: TemporalResult) -> bool:
        if self.keyframe_policy == "reference":
            return False
        if self.keyframe_policy == "every_frame":
            return True
        return (float(tr.inlier_ratio) < self.rekeyframe_min_inlier_ratio
                or int(tr.n_quads) < self.rekeyframe_min_quads)

    def _set_keyframe(self, fr: FrameResult, gt_pose: Optional[geom.Pose]):
        self.keyframe = fr
        self.kf_index = self.frame_idx
        self.kf_pose_gt = gt_pose
