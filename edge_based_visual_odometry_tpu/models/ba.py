"""Sliding-window bundle adjustment with Schur-complement reduction.

NEW CAPABILITY relative to the reference: the reference tracks against a
single keyframe (frame 0 only, src/Pipeline.cpp:133-137) and has no
window, no map, no BA (SURVEY.md §2.1 'multi-window BA does not exist in
the reference at all'). This module adds the windowed-refinement layer the
BASELINE.json north star demands, designed for fixed-shape device code:

  - Fixed-shape problem: K poses, L landmarks, O observations with masks.
  - One Gauss-Newton/LM iteration = dense batched einsums:
      * per-landmark 3x3 Hessian blocks H_ll + inversion (batched),
      * camera-landmark coupling W as a dense (L, K, 6, 3) tensor,
      * Schur complement S = H_pp - sum_l W H_ll^-1 W^T as one einsum,
      * reduced (6K, 6K) camera solve + landmark back-substitution.
  - Distributed execution: shard landmarks/observations over the mesh
    'frame' axis; the landmark-sum einsums become psum AllReduces under
    GSPMD (see parallel/mesh.py docstring) - the ring-attention-style
    scaling axis of SURVEY.md §5 'long-context'.

Pose updates use a first-order SE(3) retraction; the first pose is gauge-
fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.geometry import so3_exp as _so3_exp


class BAProblem(NamedTuple):
    R: jnp.ndarray         # (K, 3, 3) world->cam
    t: jnp.ndarray         # (K, 3)
    X: jnp.ndarray         # (L, 3) landmarks (world)
    obs_kf: jnp.ndarray    # (O,) int32 pose index
    obs_lm: jnp.ndarray    # (O,) int32 landmark index
    obs_uv: jnp.ndarray    # (O, 2) pixel measurements
    obs_w: jnp.ndarray     # (O,) weights (0 = inactive)
    K_cam: jnp.ndarray     # (3, 3) intrinsics
    # Optional landmark position prior (e.g. the stereo triangulation,
    # which constrains the depth that short low-parallax temporal tracks
    # leave nearly unobservable - without it the Schur system is close to
    # singular and f32 GN diverges). prior_w = 0 disables.
    X_prior: jnp.ndarray = None   # (L, 3)
    prior_w: jnp.ndarray = None   # () or (L,)
    # Optional per-observation edge normals (O, 2). Edge correspondences
    # only constrain the reprojection PERPENDICULAR to the edge (aperture
    # problem): tangential sliding of temporal edge matches is unobservable
    # and systematically biases a full-2D-point BA. With obs_n set, the
    # residual is the scalar normal component n . (proj - uv).
    obs_n: jnp.ndarray = None


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    X: jnp.ndarray
    cost_history: jnp.ndarray   # (n_iters + 1,) weighted mean sq px error



def _residuals_and_jacobians(p: BAProblem):
    """Reprojection residuals (O, 2) + Jacobians wrt pose (O, 2, 6:
    [omega, upsilon]) and landmark (O, 2, 3)."""
    Rk = p.R[p.obs_kf]
    tk = p.t[p.obs_kf]
    Xl = p.X[p.obs_lm]
    Xc = jnp.einsum("oij,oj->oi", Rk, Xl) + tk
    fx = p.K_cam[0, 0]
    fy = p.K_cam[1, 1]
    cx = p.K_cam[0, 2]
    cy = p.K_cam[1, 2]
    x, y, z = Xc[:, 0], Xc[:, 1], jnp.maximum(Xc[:, 2], 1e-6)
    u = fx * x / z + cx
    v = fy * y / z + cy
    r = jnp.stack([u, v], -1) - p.obs_uv

    iz = 1.0 / z
    iz2 = iz * iz
    # d(u,v)/dXc
    Jp = jnp.stack([
        jnp.stack([fx * iz, jnp.zeros_like(z), -fx * x * iz2], -1),
        jnp.stack([jnp.zeros_like(z), fy * iz, -fy * y * iz2], -1),
    ], axis=1)                                   # (O, 2, 3)
    # pose: Xc = R X + t; d/d omega (left perturbation) = -[Xc]_x, d/d t = I
    Xc_hat = jnp.zeros((Xc.shape[0], 3, 3), Xc.dtype)
    Xc_hat = Xc_hat.at[:, 0, 1].set(-Xc[:, 2]).at[:, 0, 2].set(Xc[:, 1])
    Xc_hat = Xc_hat.at[:, 1, 0].set(Xc[:, 2]).at[:, 1, 2].set(-Xc[:, 0])
    Xc_hat = Xc_hat.at[:, 2, 0].set(-Xc[:, 1]).at[:, 2, 1].set(Xc[:, 0])
    J_omega = -jnp.einsum("oij,ojk->oik", Jp, Xc_hat)   # (O, 2, 3)
    J_t = Jp
    J_pose = jnp.concatenate([J_omega, J_t], axis=-1)   # (O, 2, 6)
    J_lm = jnp.einsum("oij,ojk->oik", Jp, Rk)           # (O, 2, 3)
    if p.obs_n is not None:
        # project onto the edge normal -> scalar residual per observation
        r = jnp.sum(r * p.obs_n, -1, keepdims=True)          # (O, 1)
        J_pose = jnp.einsum("oi,oia->oa", p.obs_n, J_pose)[:, None, :]
        J_lm = jnp.einsum("oi,oia->oa", p.obs_n, J_lm)[:, None, :]
    return r, J_pose, J_lm


def ba_iteration(p: BAProblem, damping: float, huber: float):
    """One damped GN step with Schur complement on landmarks."""
    Kn = p.R.shape[0]
    L = p.X.shape[0]
    r, J_pose, J_lm = _residuals_and_jacobians(p)

    rn = jnp.linalg.norm(r, axis=-1)
    w_h = jnp.where(rn <= huber, 1.0, huber / jnp.maximum(rn, 1e-12))
    w = p.obs_w * w_h

    # --- blocks via scatter-adds over observations ---
    JtJ_pp = jnp.zeros((Kn, 6, 6)).at[p.obs_kf].add(
        w[:, None, None] * jnp.einsum("oia,oib->oab", J_pose, J_pose))
    b_p = jnp.zeros((Kn, 6)).at[p.obs_kf].add(
        -w[:, None] * jnp.einsum("oia,oi->oa", J_pose, r))

    H_ll = jnp.zeros((L, 3, 3)).at[p.obs_lm].add(
        w[:, None, None] * jnp.einsum("oia,oib->oab", J_lm, J_lm))
    b_l = jnp.zeros((L, 3)).at[p.obs_lm].add(
        -w[:, None] * jnp.einsum("oia,oi->oa", J_lm, r))
    if p.X_prior is not None and p.prior_w is not None:
        pw = jnp.broadcast_to(jnp.asarray(p.prior_w), (L,))
        H_ll = H_ll + pw[:, None, None] * jnp.eye(3)[None]
        b_l = b_l + pw[:, None] * (p.X_prior - p.X)

    # W: (L, K, 6, 3) camera-landmark coupling
    Wc = jnp.zeros((L, Kn, 6, 3)).at[p.obs_lm, p.obs_kf].add(
        w[:, None, None] * jnp.einsum("oia,oib->oab", J_pose, J_lm))

    lam = damping
    H_ll_d = H_ll + lam * jnp.eye(3)[None]
    H_ll_inv = jnp.linalg.inv(H_ll_d)

    # --- Schur complement (the distributed psum target: the einsums below
    # reduce over the landmark axis l) ---
    WHinv = jnp.einsum("lkab,lbc->lkac", Wc, H_ll_inv)      # (L, K, 6, 3)
    S_cross = jnp.einsum("lkac,lqbc->kaqb", WHinv, Wc)      # (K,6,K,6)
    S = jnp.zeros((Kn, 6, Kn, 6))
    diag = jnp.arange(Kn)
    S = S.at[diag, :, diag, :].add(JtJ_pp + lam * jnp.eye(6)[None])
    S = S - S_cross
    rhs = b_p - jnp.einsum("lkac,lc->ka", WHinv, b_l)

    # gauge fix: freeze pose 0 with a strong prior
    S = S.at[0, :, 0, :].add(1e8 * jnp.eye(6))

    Sm = S.reshape(Kn * 6, Kn * 6)
    dp = jnp.linalg.solve(Sm, rhs.reshape(-1)).reshape(Kn, 6)

    dl = jnp.einsum("lab,lb->la",
                    H_ll_inv,
                    b_l - jnp.einsum("lkab,ka->lb", Wc, dp))

    # retract
    dR = _so3_exp(dp[:, :3])
    R_new = jnp.einsum("kij,kjl->kil", dR, p.R)
    t_new = jnp.einsum("kij,kj->ki", dR, p.t) + dp[:, 3:]
    X_new = p.X + dl

    cost = jnp.sum(w * rn * rn) / jnp.maximum(jnp.sum(p.obs_w), 1.0)
    return p._replace(R=R_new, t=t_new, X=X_new), cost


def run_ba(p: BAProblem, n_iters: int = 10, damping: float = 1e-4,
           huber: float = 2.0) -> BAResult:
    """Fixed-iteration windowed BA (jittable)."""

    def body(carry, _):
        prob, = carry
        prob2, cost = ba_iteration(prob, damping, huber)
        return (prob2,), cost

    (pf,), costs = jax.lax.scan(body, (p,), None, length=n_iters)
    r, _, _ = _residuals_and_jacobians(pf)
    rn = jnp.linalg.norm(r, axis=-1)
    # Huber-weight the final entry exactly like ba_iteration's per-iter
    # costs, so cost_history is a comparable series end to end
    w = pf.obs_w * jnp.minimum(1.0, huber / jnp.maximum(rn, 1e-12))
    final_cost = (jnp.sum(w * rn * rn)
                  / jnp.maximum(jnp.sum(pf.obs_w), 1.0))
    return BAResult(R=pf.R, t=pf.t, X=pf.X,
                    cost_history=jnp.concatenate([costs,
                                                  final_cost[None]]))
