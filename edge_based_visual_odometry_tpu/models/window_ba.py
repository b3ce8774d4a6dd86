"""Multi-keyframe track builder + sliding-window BA integration.

NEW CAPABILITY (SURVEY.md §7 step 7): the reference tracks only against
frame 0 and has no window/map. Here, with the 'every_frame' keyframe
policy, consecutive keyframes are chained into landmark TRACKS through the
temporal quad matches (each quad links a KF mate row to a CF mate index,
and the CF becomes the next keyframe), and a sliding window of keyframe
poses + tracked 3D edge points is refined by the Schur-complement BA of
models/ba.py.

Host-side bookkeeping is fully VECTORIZED numpy over the fixed mate-slot
axis: at production density a keyframe carries ~24k mates per frame under
the `every_frame` policy, so per-slot Python loops would cost more than
the device solve. Track propagation is a
scatter, track counting is np.unique, and window assembly is one
flattened (keyframe, slot) pass.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as geom
from edge_based_visual_odometry_tpu.models import ba as BA


@dataclasses.dataclass
class WindowBAConfig:
    window: int = 5            # keyframes in the optimization window
    min_track_len: int = 2
    # Capacities sized for HONEST production density (4096/16384 would
    # sit far below the ~24k mates per keyframe and truncate every
    # frame): with window=5 and ~24k mates, qualifying tracks reach
    # ~max_mates and observations ~window * mates.
    max_landmarks: int = 32768
    max_obs: int = 131072
    n_iters: int = 8
    damping: float = 1e-3
    huber: float = 2.0
    # weight of the stereo-triangulation landmark prior (1/sigma^2 with
    # sigma ~ 0.2 m); essential for 2-view low-parallax tracks
    prior_weight: float = 25.0
    # landmark depth sanity bounds (camera frame, meters at rig scale):
    # near-zero-disparity stereo triangulations explode to huge depths and
    # ill-condition the Schur solve (observed: NaN poses poisoning the
    # whole trajectory). Out-of-range observations are skipped.
    min_depth: float = 1e-2
    max_depth: float = 1e3


class WindowBA:
    """Accumulates keyframe poses + landmark tracks; runs windowed BA.

    `mesh`: optional jax.sharding.Mesh. When set, the solve shards the
    landmark and observation axes over the mesh's first axis (poses and
    intrinsics replicated); XLA inserts the Schur-complement
    AllReduces. max_landmarks / max_obs are static, so the sharded program
    caches across frames exactly like the single-device one.
    """

    def __init__(self, K_cam: np.ndarray, cfg: WindowBAConfig = WindowBAConfig(),
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.K_cam = np.asarray(K_cam, np.float32)
        self._next_track = 0
        # per-keyframe arrays over the fixed mate-slot axis:
        self.kf_poses: List[np.ndarray] = []   # (4, 4) homogeneous world->cam
        self.kf_tid: List[np.ndarray] = []     # (M,) int64 track id, -1 = none
        self.kf_uv: List[np.ndarray] = []      # (M, 2) f32 left-image locs
        self.kf_normal: List[np.ndarray] = []  # (M, 2) f32 edge normals
        self.kf_gamma: List[np.ndarray] = []   # (M, 3) f64 camera-frame 3D

    def add_keyframe(self, mates, pose_est: geom.Pose,
                     links: Optional[np.ndarray] = None):
        """Register a new keyframe.

        mates: StereoMates of the new keyframe.
        pose_est: world->cam pose estimate of the new keyframe.
        links: optional (M_prev,) int array mapping the PREVIOUS keyframe's
          mate rows to this keyframe's mate indices (-1 = no link) - the
          best temporal quad candidates. Linked mates continue the track.
        """
        valid = np.asarray(mates.valid)
        lx = np.asarray(mates.left_x)
        ly = np.asarray(mates.left_y)
        lt = np.asarray(mates.left_theta)
        gamma = np.asarray(mates.gamma, np.float64)
        # drop degenerate triangulations (see WindowBAConfig depth bounds)
        depth_ok = (np.isfinite(gamma).all(axis=-1)
                    & (gamma[:, 2] > self.cfg.min_depth)
                    & (gamma[:, 2] < self.cfg.max_depth))
        valid = valid & depth_ok
        M = valid.shape[0]

        tid = np.full(M, -1, np.int64)
        if links is not None and self.kf_tid:
            prev_tid = self.kf_tid[-1]
            links = np.asarray(links)
            src = (prev_tid >= 0) & (links >= 0)
            cf_slot = links[src]
            ok = valid[cf_slot]
            # scatter: ascending-prev-slot order, last write wins (the
            # dict version iterated prev insertion order; collisions are
            # two prev tracks claiming one CF mate - either is a valid
            # continuation)
            tid[cf_slot[ok]] = prev_tid[src][ok]
        new_mask = valid & (tid < 0)
        n_new = int(new_mask.sum())
        tid[new_mask] = self._next_track + np.arange(n_new)
        self._next_track += n_new

        R = np.asarray(pose_est.R, np.float64)
        t = np.asarray(pose_est.t, np.float64)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        self.kf_poses.append(T)
        self.kf_tid.append(tid)
        self.kf_uv.append(np.stack([lx, ly], -1).astype(np.float32))
        # edge normal (perpendicular to the edge direction)
        self.kf_normal.append(
            np.stack([-np.sin(lt), np.cos(lt)], -1).astype(np.float32))
        self.kf_gamma.append(gamma)

        w = self.cfg.window
        if len(self.kf_poses) > w:
            self.kf_poses = self.kf_poses[-w:]
            self.kf_tid = self.kf_tid[-w:]
            self.kf_uv = self.kf_uv[-w:]
            self.kf_normal = self.kf_normal[-w:]
            self.kf_gamma = self.kf_gamma[-w:]

    def run(self):
        """Assemble + solve the window problem. Returns
        (poses_w2c list of geom.Pose, info dict) or None if the window is
        too small. info includes host-assembly wall time so longseq runs
        can assert bookkeeping < solve cost."""
        import time
        t_host0 = time.perf_counter()
        Kn = len(self.kf_poses)
        if Kn < 2:
            return None

        # ---- track census over the window (vectorized np.unique) ----
        tids = np.stack(self.kf_tid)            # (K, M)
        vm = tids >= 0
        uniq, counts = np.unique(tids[vm], return_counts=True)
        cand = uniq[counts >= self.cfg.min_track_len]
        if cand.size > self.cfg.max_landmarks:
            import warnings
            warnings.warn(
                f"WindowBA: {cand.size} qualifying tracks exceed "
                f"max_landmarks={self.cfg.max_landmarks}; keeping the "
                "longest tracks - raise WindowBAConfig.max_landmarks to "
                "use all")
            # deterministic, quality-ranked truncation (longest tracks
            # constrain the solve most)
            ccnt = counts[counts >= self.cfg.min_track_len]
            order = np.lexsort((cand, -ccnt))
            keep = np.sort(cand[order][: self.cfg.max_landmarks])
        else:
            keep = cand                          # already sorted by unique
        L = int(keep.size)
        if L < 10:
            return None

        # ---- flatten (keyframe, slot) observations of kept tracks ----
        kk, ss = np.nonzero(vm)                  # k-major, slot-ascending
        t_flat = tids[kk, ss]
        pos = np.searchsorted(keep, t_flat)
        in_keep = (pos < L) & (keep[np.minimum(pos, L - 1)] == t_flat)
        kk, ss, li = kk[in_keep], ss[in_keep], pos[in_keep]
        n_obs = int(kk.size)
        if n_obs > self.cfg.max_obs:
            import warnings
            warnings.warn(
                f"WindowBA: truncating {n_obs} observations to "
                f"max_obs={self.cfg.max_obs}; raise WindowBAConfig.max_obs "
                f"to use all tracks", stacklevel=2)
            kk, ss, li = kk[: self.cfg.max_obs], ss[: self.cfg.max_obs], \
                li[: self.cfg.max_obs]
            n_obs = self.cfg.max_obs

        uvs = np.stack(self.kf_uv)               # (K, M, 2)
        nrm = np.stack(self.kf_normal)
        obs_uv = uvs[kk, ss]
        obs_n = nrm[kk, ss]

        # ---- landmark init: FIRST (earliest-keyframe) observation's
        # stereo triangulation lifted to world. Reverse fancy assignment
        # leaves the first occurrence per landmark. ----
        first = np.full(L, -1, np.int64)
        first[li[::-1]] = np.arange(n_obs - 1, -1, -1)
        gammas = np.stack(self.kf_gamma)         # (K, M, 3)
        g0 = gammas[kk[first], ss[first]]
        Tinv = np.linalg.inv(np.stack(self.kf_poses))   # (K, 4, 4)
        Ti = Tinv[kk[first]]
        X0 = np.einsum("lij,lj->li", Ti[:, :3, :3], g0) + Ti[:, :3, 3]

        # pad to static shapes so the jitted solve caches across frames
        Lp = self.cfg.max_landmarks
        Op = self.cfg.max_obs
        X_pad = np.full((Lp, 3), 5.0)
        X_pad[:L] = X0
        kf_pad = np.zeros(Op, np.int32)
        lm_pad = np.zeros(Op, np.int32)
        uv_pad = np.zeros((Op, 2), np.float32)
        w_pad = np.zeros(Op, np.float32)
        n_pad = np.zeros((Op, 2), np.float32)
        n_pad[:, 1] = 1.0
        kf_pad[:n_obs] = kk
        lm_pad[:n_obs] = li
        uv_pad[:n_obs] = obs_uv
        n_pad[:n_obs] = obs_n
        w_pad[:n_obs] = 1.0
        host_assembly_s = time.perf_counter() - t_host0

        prob = BA.BAProblem(
            R=jnp.asarray(np.stack([T[:3, :3] for T in self.kf_poses]),
                          jnp.float32),
            t=jnp.asarray(np.stack([T[:3, 3] for T in self.kf_poses]),
                          jnp.float32),
            X=jnp.asarray(X_pad, jnp.float32),
            obs_kf=jnp.asarray(kf_pad),
            obs_lm=jnp.asarray(lm_pad),
            obs_uv=jnp.asarray(uv_pad),
            obs_w=jnp.asarray(w_pad),
            K_cam=jnp.asarray(self.K_cam),
            X_prior=jnp.asarray(X_pad, jnp.float32),
            prior_w=jnp.float32(self.cfg.prior_weight),
            obs_n=jnp.asarray(n_pad))
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            axis = self.mesh.axis_names[0]
            shard = NamedSharding(self.mesh, P(axis))
            repl = NamedSharding(self.mesh, P())
            prob = prob._replace(
                X=jax.device_put(prob.X, shard),
                X_prior=jax.device_put(prob.X_prior, shard),
                obs_kf=jax.device_put(prob.obs_kf, shard),
                obs_lm=jax.device_put(prob.obs_lm, shard),
                obs_uv=jax.device_put(prob.obs_uv, shard),
                obs_w=jax.device_put(prob.obs_w, shard),
                obs_n=jax.device_put(prob.obs_n, shard),
                R=jax.device_put(prob.R, repl),
                t=jax.device_put(prob.t, repl),
                K_cam=jax.device_put(prob.K_cam, repl))
        if not hasattr(self, "_solver"):
            self._solver = jax.jit(lambda p: BA.run_ba(
                p, n_iters=self.cfg.n_iters, damping=self.cfg.damping,
                huber=self.cfg.huber))
        t_solve0 = time.perf_counter()
        res = jax.block_until_ready(self._solver(prob))
        solve_s = time.perf_counter() - t_solve0

        # a diverged solve (ill-conditioned Schur system) must not poison
        # the odometry: reject non-finite results and keep the incoming
        # poses (the VO loop treats None as "no BA correction")
        R_all = np.asarray(res.R[:Kn])
        t_all = np.asarray(res.t[:Kn])
        if not (np.isfinite(R_all).all() and np.isfinite(t_all).all()
                and np.isfinite(float(res.cost_history[-1]))):
            import warnings
            warnings.warn("WindowBA: solve diverged (non-finite result); "
                          "keeping odometry poses", stacklevel=2)
            return None

        poses = []
        for k in range(Kn):
            R = np.asarray(res.R[k], np.float64)
            t = np.asarray(res.t[k], np.float64)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = t
            self.kf_poses[k] = T
            poses.append(geom.Pose(jnp.asarray(R, jnp.float32),
                                   jnp.asarray(t, jnp.float32)))
        info = {
            "n_landmarks": L,
            "n_obs": n_obs,
            "cost": np.asarray(res.cost_history),
            "host_assembly_s": host_assembly_s,
            "solve_s": solve_s,
        }
        return poses, info


def best_links_from_quads(tr) -> np.ndarray:
    """Extract the (M,) best CF-mate index per KF mate row from a
    TemporalResult (-1 where no surviving candidate)."""
    quads = tr.quads
    cmask = np.asarray(quads.cmask)
    ncc = np.asarray(quads.ncc_l)
    cf_idx = np.asarray(quads.cf_idx)
    score = np.where(cmask, ncc, -np.inf)
    best = score.argmax(axis=1)
    has = score.max(axis=1) > -np.inf
    out = np.where(has, cf_idx[np.arange(len(best)), best], -1)
    return out.astype(np.int64)
