"""Photometric Gauss-Newton refiners as fixed-iteration lax.scan kernels.

Two refiners, both operating on mean-centered two-side rotated patches with
Huber weighting:

  - `refine_along_epipolar`: 1-DoF shift of the right candidate along the
    epipolar direction (reference
    min_Edge_Photometric_Residual_by_Gauss_Newton_along_EpipolarLine,
    src/Stereo_Matches.cpp:1159-1288).
  - `refine_2dof`: full 2-DoF translation between KF and CF edges with a
    2x2 LDLT-equivalent solve (reference
    Temporal_Matches::min_Edge_Photometric_Residual_by_Gauss_Newton,
    src/Temporal_Matches.cpp:735-851).

The reference breaks out of its iteration loop on |delta| < tol; here a
`done` flag freezes the carry so all lanes run the same fixed 20 iterations
(static shapes for XLA), producing identical results for converged lanes.
Designed to be vmapped over flat candidate lists.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import patches as P


class RefineResult(NamedTuple):
    delta: jnp.ndarray       # refined shift: scalar alpha (1-DoF) or (2,) disp
    score: jnp.ndarray       # final RMS residual
    confidence: jnp.ndarray  # exp(-rms / huber)
    valid: jnp.ndarray       # bool: converged after iter 0 and rms within 2*huber
    iters: jnp.ndarray = None  # per-lane iterations to convergence (diagnostic)


def _centered_left_patches(img, x, y, theta, patch_size):
    """Left/KF patch preparation shared by both refiners
    (Stereo_Matches.cpp:1169-1193): two side patches at +- (P/2 + 1) along
    the edge normal, mean-centered. Samples are clamped (the reference uses
    util_bilinear_Sample_F here, not the NaN variant)."""
    side = patch_size / 2.0 + 1.0
    t = jnp.stack([jnp.cos(theta), jnp.sin(theta)], -1)
    n = jnp.stack([-t[..., 1], t[..., 0]], -1)
    c_plus = jnp.stack([x, y], -1) + n * side
    c_minus = jnp.stack([x, y], -1) - n * side
    cp = P.rotated_patch_coords(c_plus[..., 0], c_plus[..., 1], theta, patch_size)
    cm = P.rotated_patch_coords(c_minus[..., 0], c_minus[..., 1], theta, patch_size)
    lp = P.sample_patch(img, cp)
    lm = P.sample_patch(img, cm)
    lp = lp - jnp.mean(lp, axis=-1, keepdims=True)
    lm = lm - jnp.mean(lm, axis=-1, keepdims=True)
    return lp, lm, n


def refine_along_epipolar(left_img, right_img, right_gx, right_gy,
                          lx, ly, ltheta, rx, ry, epi_dir,
                          patch_size: int = 7, max_iter: int = 20,
                          tol: float = 1e-3, huber_delta: float = 1.0) -> RefineResult:
    """1-DoF GN along the (unit) epipolar direction, alpha init 0
    (Stereo_Matches.cpp:1159-1288; driver :1290-1358).

    All edge args are scalars (vmap over candidates). Patch rotation uses
    the LEFT edge orientation on both sides, as in the reference
    (Stereo_Matches.cpp:1208-1209).
    """
    side = patch_size / 2.0 + 1.0
    lp, lm, n = _centered_left_patches(left_img, lx, ly, ltheta, patch_size)
    n_samples = 2 * patch_size * patch_size

    def body(carry, _):
        alpha, done, score, conf, valid, it = carry
        shift = alpha * epi_dir
        c_plus = jnp.stack([rx, ry], -1) + n * side + shift
        c_minus = jnp.stack([rx, ry], -1) - n * side + shift
        cp = P.rotated_patch_coords(c_plus[..., 0], c_plus[..., 1], ltheta, patch_size)
        cm = P.rotated_patch_coords(c_minus[..., 0], c_minus[..., 1], ltheta, patch_size)

        def accum(lc, coords):
            rv = P.sample_patch(right_img, coords)
            gx = P.sample_patch(right_gx, coords)
            gy = P.sample_patch(right_gy, coords)
            rv = rv - jnp.mean(rv, axis=-1, keepdims=True)
            r = lc - rv
            # projected gradient (Stereo_Matches.cpp:1240): note the minus
            # on the x term.
            g = -gx * epi_dir[0] + gy * epi_dir[1]
            absr = jnp.abs(r)
            w = jnp.where(absr <= huber_delta, 1.0, huber_delta / absr)
            H = jnp.sum(w * g * g, -1)
            b = jnp.sum(w * g * r, -1)
            cost = jnp.sum(w * r * r, -1)
            return H, b, cost

        Hp, bp, cp_ = accum(lp, cp)
        Hm, bm, cm_ = accum(lm, cm)
        H = Hp + Hm
        b = bp + bm
        cost = cp_ + cm_

        degenerate = H < 1e-8
        delta = jnp.where(degenerate, 0.0, -b / jnp.maximum(H, 1e-8))
        new_alpha = alpha + delta
        rms = jnp.sqrt(cost / n_samples)
        converged = (jnp.abs(delta) < tol) | (it == max_iter - 1)
        # is_outlier: rms too large OR converged on the very first iteration
        # (residual_log.size() < 2 at the check, Stereo_Matches.cpp:1275)
        is_outlier = (rms > huber_delta * 2.0) | (it < 1)
        finish = converged & ~done & ~degenerate

        score = jnp.where(finish, rms, score)
        conf = jnp.where(finish, jnp.exp(-rms / huber_delta), conf)
        valid = jnp.where(finish, ~is_outlier, valid)
        alpha = jnp.where(done | degenerate, alpha, new_alpha)
        done = done | converged | degenerate
        return (alpha, done, score, conf, valid, it + 1), None

    init = (jnp.float32(0.0), jnp.bool_(False), jnp.float32(1e6),
            jnp.float32(0.0), jnp.bool_(False), jnp.int32(0))
    (alpha, _, score, conf, valid, _), _ = jax.lax.scan(
        body, init, None, length=max_iter)
    return RefineResult(alpha, score, conf, valid)


def refine_2dof(kf_img, cf_img, cf_gx, cf_gy,
                kx, ky, ktheta, cx, cy, ctheta,
                patch_size: int = 7, max_iter: int = 20,
                tol: float = 1e-3, huber_delta: float = 3.0) -> RefineResult:
    """2-DoF photometric GN between a KF edge and a CF candidate edge
    (Temporal_Matches.cpp:735-851). Initial displacement d = kf - cf; the
    CF patch center is kf - d, rotated by the CF orientation; the normal
    n_cf also comes from the CF orientation (Temporal_Matches.cpp:770-780).
    Returns the refined displacement d (CF location = kf - d)."""
    side = patch_size / 2.0 + 1.0
    lp, lm, _ = _centered_left_patches(kf_img, kx, ky, ktheta, patch_size)
    n_samples = 2 * patch_size * patch_size
    t_cf = jnp.stack([jnp.cos(ctheta), jnp.sin(ctheta)], -1)
    n_cf = jnp.stack([-t_cf[..., 1], t_cf[..., 0]], -1)
    kf_loc = jnp.stack([kx, ky], -1)
    d0 = jnp.stack([kx - cx, ky - cy], -1)

    def body(carry, _):
        d, done, score, conf, valid, it = carry
        loc = kf_loc - d
        c_plus = loc + n_cf * side
        c_minus = loc - n_cf * side
        cp = P.rotated_patch_coords(c_plus[..., 0], c_plus[..., 1], ctheta, patch_size)
        cm = P.rotated_patch_coords(c_minus[..., 0], c_minus[..., 1], ctheta, patch_size)

        def accum(lc, coords):
            rv = P.sample_patch(cf_img, coords)
            gx = P.sample_patch(cf_gx, coords)
            gy = P.sample_patch(cf_gy, coords)
            rv = rv - jnp.mean(rv, axis=-1, keepdims=True)
            r = lc - rv
            absr = jnp.abs(r)
            w = jnp.where(absr < huber_delta, 1.0, huber_delta / absr)
            H00 = jnp.sum(w * gx * gx, -1)
            H01 = jnp.sum(w * gx * gy, -1)
            H11 = jnp.sum(w * gy * gy, -1)
            b0 = jnp.sum(w * gx * r, -1)
            b1 = jnp.sum(w * gy * r, -1)
            cost = jnp.sum(w * r * r, -1)
            return H00, H01, H11, b0, b1, cost

        a = accum(lp, cp)
        b_ = accum(lm, cm)
        # The reference adds 1e-6*I per sample (Temporal_Matches.cpp:815
        # inside the loop) -> total 2 * P^2 * 1e-6.
        reg = 1e-6 * n_samples
        H00 = a[0] + b_[0] + reg
        H01 = a[1] + b_[1]
        H11 = a[2] + b_[2] + reg
        b0 = a[3] + b_[3]
        b1 = a[4] + b_[4]
        cost = a[5] + b_[5]

        det = H00 * H11 - H01 * H01
        inv_det = 1.0 / det
        d0_ = -(H11 * b0 - H01 * b1) * inv_det
        d1_ = -(-H01 * b0 + H00 * b1) * inv_det
        delta = jnp.stack([d0_, d1_], -1)
        new_d = d + delta
        rms = jnp.sqrt(cost / n_samples)
        converged = (jnp.linalg.norm(delta) < tol) | (it == max_iter - 1)
        is_outlier = (rms > huber_delta * 2.0) | (it < 1)
        finish = converged & ~done

        score = jnp.where(finish, rms, score)
        conf = jnp.where(finish, jnp.exp(-rms / huber_delta), conf)
        valid = jnp.where(finish, ~is_outlier, valid)
        d = jnp.where(done, d, new_d)
        done = done | converged
        return (d, done, score, conf, valid, it + 1), None

    init = (d0, jnp.bool_(False), jnp.float32(1e6),
            jnp.float32(0.0), jnp.bool_(False), jnp.int32(0))
    (d, _, score, conf, valid, _), _ = jax.lax.scan(
        body, init, None, length=max_iter)
    return RefineResult(d, score, conf, valid)


# ---------------------------------------------------------------------------
# Batched tile-resident refiners (the production path).
#
# The scalar+vmap versions above lower every bilinear sample to an element
# gather - O(10^8) random accesses per frame. These variants fetch one
# tile per candidate up front (slice-gather) and turn all in-tile sampling
# into batched einsums (ops/tiled_sampling.py), processing candidates in
# sequential chunks to bound device memory. Whether a GPU prefers direct
# bilinear gathers is not measured yet.
# ---------------------------------------------------------------------------

from edge_based_visual_odometry_tpu.ops import tiled_sampling as TS  # noqa: E402


def _rotated_two_side_coords(cx, cy, theta, n, side, patch_size):
    """(B, 2*P*P, 2) coords of the plus/minus rotated patches around
    (cx, cy) shifted +-side along n. All args (B,)-shaped."""
    c_plus = jnp.stack([cx, cy], -1) + n * side
    c_minus = jnp.stack([cx, cy], -1) - n * side
    cp = P.rotated_patch_coords(c_plus[..., 0], c_plus[..., 1], theta, patch_size)
    cm = P.rotated_patch_coords(c_minus[..., 0], c_minus[..., 1], theta, patch_size)
    return jnp.concatenate([cp, cm], axis=-2)


def _two_phase(run, B: int, args, active, delta0,
               phase1_iters: int, phase2_budget: int, max_iter: int,
               chunk: int, phase1_chunk: int = 0):
    """Convergence-compaction driver shared by both batch refiners.

    `run(args, delta0, it0, it_stop, act, chunk)` executes GN iterations
    [it0, it_stop) and returns (RefineResult, done). Most lanes converge
    in a handful of iterations while a chunk's while_loop runs until its
    SLOWEST lane converges - so phase 1 gives every lane `phase1_iters`
    iterations, then only the unconverged minority (compacted to the
    front of a `phase2_budget` buffer) pays for the remaining
    iterations. Lanes past the budget keep their phase-1 state
    (valid=False -> dropped conservatively downstream).

    `phase1_chunk`: phase 1 runs a FIXED iteration count, so its chunks
    have no convergence-coupling penalty (a chunk's while_loop running
    until its slowest lane converges is what makes wide chunks lose in
    phase 2) - wider phase-1 chunks cut the serial chunk count ~8x at
    the production budgets. 0 = use `chunk`. Chunking never changes
    results (lanes are independent; frozen carries), only wall time."""
    r1, done1 = run(args, delta0, 0, phase1_iters, active,
                    phase1_chunk or chunk)
    # skipped all-inactive chunks zero-fill done -> force inactive=done
    done1 = done1 | ~active
    B2 = min(B, max(chunk, phase2_budget))
    from edge_based_visual_odometry_tpu.ops import sortfree as SF
    order = SF.partition_order_stable(done1)   # unconverged-first, stable
    idx = order[:B2]
    act2 = ~done1[idx]
    args2 = jax.tree_util.tree_map(lambda a: a[idx], args)
    r2, _ = run(args2, r1.delta[idx], phase1_iters, max_iter, act2, chunk)

    def merge(a, b):
        take = act2 if b.ndim == 1 else act2[:, None]
        return a.at[idx].set(jnp.where(take, b, a[idx]),
                             unique_indices=True)

    return RefineResult(merge(r1.delta, r2.delta), merge(r1.score, r2.score),
                        merge(r1.confidence, r2.confidence),
                        merge(r1.valid, r2.valid),
                        merge(r1.iters, r2.iters))


def refine_along_epipolar_batch(left_img, right_img, right_gx, right_gy,
                                lx, ly, ltheta, rx, ry, epi_dir,
                                patch_size: int = 7, max_iter: int = 20,
                                tol: float = 1e-3, huber_delta: float = 1.0,
                                tile: int = 48, chunk: int = 2048,
                                active=None, phase1_iters: int = 0,
                                phase2_budget: int = 0,
                                phase1_chunk: int = 0,
                                weight_split: bool = False) -> RefineResult:
    """Batched 1-DoF epipolar GN (same math as refine_along_epipolar).
    All edge args (B,); epi_dir (B, 2). GN travel is bounded by the tile
    (+-(tile/2 - patch extent) px; documented deviation).

    `active`: optional (B,) mask - inactive lanes start converged, so with
    actives packed first (the flat-compaction layout) whole tail chunks
    run zero iterations of the while_loop.

    `phase1_iters` > 0 enables two-phase convergence compaction (see
    _two_phase); results for lanes within the phase-2 budget are
    identical to the single-phase path."""
    B = lx.shape[0]
    if active is None:
        active = jnp.ones((B,), bool)
    side = patch_size / 2.0 + 1.0
    pp = patch_size * patch_size
    n_samples = 2 * pp
    stride = tile // 3 if tile % 3 == 0 else tile // 4
    right_atlas = TS.build_atlas(
        jnp.stack([right_img, right_gx, right_gy]), tile, stride)
    left_atlas = TS.build_atlas(left_img[None], 32, 8)
    H, W = left_img.shape

    def make_run(it_stop):
        def run_chunk(args):
            lx_c, ly_c, lt_c, rx_c, ry_c, dir_c, act_c, alpha0_c, it0_c = args
            t = jnp.stack([jnp.cos(lt_c), jnp.sin(lt_c)], -1)
            n = jnp.stack([-t[..., 1], t[..., 0]], -1)

            lcoords = _rotated_two_side_coords(lx_c, ly_c, lt_c, n, side,
                                               patch_size)
            lvals = TS.sample_atlas(left_atlas, lx_c, ly_c,
                                    lcoords[..., 0], lcoords[..., 1])[:, 0]
            lp = lvals[:, :pp]
            lm = lvals[:, pp:]
            lp = lp - jnp.mean(lp, -1, keepdims=True)
            lm = lm - jnp.mean(lm, -1, keepdims=True)

            tiles, ox, oy = TS.fetch_atlas_tiles(right_atlas, rx_c, ry_c)

            def body(carry):
                alpha, done, score, conf, valid, conv, it = carry
                shift = alpha[:, None] * dir_c
                rc = _rotated_two_side_coords(rx_c + shift[:, 0],
                                              ry_c + shift[:, 1],
                                              lt_c, n, side, patch_size)
                vals = TS.bilinear_sample_tiles(
                    tiles, ox, oy, rc[..., 0], rc[..., 1],
                    grad_precision=jax.lax.Precision.DEFAULT,
                    weight_split=weight_split)
                rv = vals[:, 0]
                gx = vals[:, 1]
                gy = vals[:, 2]
                rvp = rv[:, :pp] - jnp.mean(rv[:, :pp], -1, keepdims=True)
                rvm = rv[:, pp:] - jnp.mean(rv[:, pp:], -1, keepdims=True)
                r = jnp.concatenate([lp - rvp, lm - rvm], -1)
                g = -gx * dir_c[:, 0:1] + gy * dir_c[:, 1:2]
                absr = jnp.abs(r)
                w = jnp.where(absr <= huber_delta, 1.0, huber_delta / absr)
                Hh = jnp.sum(w * g * g, -1)
                b = jnp.sum(w * g * r, -1)
                cost = jnp.sum(w * r * r, -1)

                degenerate = Hh < 1e-8
                delta = jnp.where(degenerate, 0.0,
                                  -b / jnp.maximum(Hh, 1e-8))
                new_alpha = alpha + delta
                rms = jnp.sqrt(cost / n_samples)
                converged = (jnp.abs(delta) < tol) | (it == max_iter - 1)
                is_outlier = (rms > huber_delta * 2.0) | (it < 1)
                finish = converged & ~done & ~degenerate
                score = jnp.where(finish, rms, score)
                conf = jnp.where(finish, jnp.exp(-rms / huber_delta), conf)
                valid = jnp.where(finish, ~is_outlier, valid)
                alpha = jnp.where(done | degenerate, alpha, new_alpha)
                conv = jnp.where(done, conv, it + 1)
                done = done | converged | degenerate
                return (alpha, done, score, conf, valid, conv, it + 1)

            b = lx_c.shape[0]
            init = (alpha0_c, ~act_c, jnp.full(b, 1e6),
                    jnp.zeros(b), jnp.zeros(b, bool),
                    jnp.zeros(b, jnp.int32), it0_c[0])
            out = jax.lax.while_loop(
                lambda c: (c[6] < it_stop) & jnp.any(~c[1]), body, init)
            return (RefineResult(out[0], out[2], out[3], out[4], out[5]),
                    out[1])
        return run_chunk

    def run(args, delta0, it0, it_stop, act, chunk_=chunk):
        lx_, ly_, lt_, rx_, ry_, dir_ = args
        b = lx_.shape[0]
        it0_arr = jnp.full((b,), it0, jnp.int32)
        return TS.map_chunked(
            make_run(it_stop),
            (lx_, ly_, lt_, rx_, ry_, dir_, act, delta0, it0_arr),
            b, chunk_, active=act)

    args = (lx, ly, ltheta, rx, ry, epi_dir)
    if not phase1_iters or phase1_iters >= max_iter:
        res, _ = run(args, jnp.zeros((B,)), 0, max_iter, active)
        return res
    return _two_phase(run, B, args, active, jnp.zeros((B,)),
                      phase1_iters, phase2_budget, max_iter, chunk,
                      phase1_chunk)


def refine_2dof_batch(kf_img, cf_img, cf_gx, cf_gy,
                      kx, ky, ktheta, cx, cy, ctheta,
                      patch_size: int = 7, max_iter: int = 20,
                      tol: float = 1e-3, huber_delta: float = 3.0,
                      tile: int = 48, chunk: int = 2048,
                      active=None, phase1_iters: int = 0,
                      phase2_budget: int = 0,
                      phase1_chunk: int = 0,
                      weight_split: bool = False) -> RefineResult:
    """Batched 2-DoF photometric GN (same math as refine_2dof); see
    refine_along_epipolar_batch for the `active` / `phase1_iters`
    semantics. The phase-1 initial displacement is d0 = kf - cf."""
    B = kx.shape[0]
    if active is None:
        active = jnp.ones((B,), bool)
    side = patch_size / 2.0 + 1.0
    pp = patch_size * patch_size
    n_samples = 2 * pp
    stride = tile // 3 if tile % 3 == 0 else tile // 4
    cf_atlas = TS.build_atlas(jnp.stack([cf_img, cf_gx, cf_gy]),
                              tile, stride)
    kf_atlas = TS.build_atlas(kf_img[None], 32, 8)
    H, W = kf_img.shape

    def make_run(it_stop):
        def run_chunk(args):
            (kx_c, ky_c, kt_c, cx_c, cy_c, ct_c, act_c,
             d0_c, it0_c) = args
            t_kf = jnp.stack([jnp.cos(kt_c), jnp.sin(kt_c)], -1)
            n_kf = jnp.stack([-t_kf[..., 1], t_kf[..., 0]], -1)
            lcoords = _rotated_two_side_coords(kx_c, ky_c, kt_c, n_kf, side,
                                               patch_size)
            lvals = TS.sample_atlas(kf_atlas, kx_c, ky_c,
                                    lcoords[..., 0], lcoords[..., 1])[:, 0]
            lp = lvals[:, :pp] - jnp.mean(lvals[:, :pp], -1, keepdims=True)
            lm = lvals[:, pp:] - jnp.mean(lvals[:, pp:], -1, keepdims=True)

            t_cf = jnp.stack([jnp.cos(ct_c), jnp.sin(ct_c)], -1)
            n_cf = jnp.stack([-t_cf[..., 1], t_cf[..., 0]], -1)
            tiles, ox, oy = TS.fetch_atlas_tiles(cf_atlas, cx_c, cy_c)
            kf_loc = jnp.stack([kx_c, ky_c], -1)
            reg = 1e-6 * n_samples

            def body(carry):
                d, done, score, conf, valid, conv, it = carry
                loc = kf_loc - d
                rc = _rotated_two_side_coords(loc[:, 0], loc[:, 1], ct_c,
                                              n_cf, side, patch_size)
                vals = TS.bilinear_sample_tiles(
                    tiles, ox, oy, rc[..., 0], rc[..., 1],
                    grad_precision=jax.lax.Precision.DEFAULT,
                    weight_split=weight_split)
                rv, gx, gy = vals[:, 0], vals[:, 1], vals[:, 2]
                rvp = rv[:, :pp] - jnp.mean(rv[:, :pp], -1, keepdims=True)
                rvm = rv[:, pp:] - jnp.mean(rv[:, pp:], -1, keepdims=True)
                r = jnp.concatenate([lp - rvp, lm - rvm], -1)
                absr = jnp.abs(r)
                w = jnp.where(absr < huber_delta, 1.0, huber_delta / absr)
                H00 = jnp.sum(w * gx * gx, -1) + reg
                H01 = jnp.sum(w * gx * gy, -1)
                H11 = jnp.sum(w * gy * gy, -1) + reg
                b0 = jnp.sum(w * gx * r, -1)
                b1 = jnp.sum(w * gy * r, -1)
                cost = jnp.sum(w * r * r, -1)
                det = H00 * H11 - H01 * H01
                inv = 1.0 / det
                delta = jnp.stack([-(H11 * b0 - H01 * b1) * inv,
                                   -(-H01 * b0 + H00 * b1) * inv], -1)
                new_d = d + delta
                rms = jnp.sqrt(cost / n_samples)
                converged = ((jnp.linalg.norm(delta, axis=-1) < tol)
                             | (it == max_iter - 1))
                is_outlier = (rms > huber_delta * 2.0) | (it < 1)
                finish = converged & ~done
                score = jnp.where(finish, rms, score)
                conf = jnp.where(finish, jnp.exp(-rms / huber_delta), conf)
                valid = jnp.where(finish, ~is_outlier, valid)
                d = jnp.where(done[:, None], d, new_d)
                conv = jnp.where(done, conv, it + 1)
                done = done | converged
                return (d, done, score, conf, valid, conv, it + 1)

            b = kx_c.shape[0]
            init = (d0_c, ~act_c, jnp.full(b, 1e6),
                    jnp.zeros(b), jnp.zeros(b, bool),
                    jnp.zeros(b, jnp.int32), it0_c[0])
            out = jax.lax.while_loop(
                lambda c: (c[6] < it_stop) & jnp.any(~c[1]), body, init)
            return (RefineResult(out[0], out[2], out[3], out[4], out[5]),
                    out[1])
        return run_chunk

    def run(args, delta0, it0, it_stop, act, chunk_=chunk):
        kx_, ky_, kt_, cx_, cy_, ct_ = args
        b = kx_.shape[0]
        it0_arr = jnp.full((b,), it0, jnp.int32)
        return TS.map_chunked(
            make_run(it_stop),
            (kx_, ky_, kt_, cx_, cy_, ct_, act, delta0, it0_arr),
            b, chunk_, active=act)

    args = (kx, ky, ktheta, cx, cy, ctheta)
    d0 = jnp.stack([kx - cx, ky - cy], -1)
    if not phase1_iters or phase1_iters >= max_iter:
        res, _ = run(args, d0, 0, max_iter, active)
        return res
    return _two_phase(run, B, args, active, d0,
                      phase1_iters, phase2_budget, max_iter, chunk,
                      phase1_chunk)
