"""Core projective / epipolar geometry as pure JAX functions.

Re-designs the reference's Eigen-based scalar helpers as batched jnp ops:

  - Pose algebra           (reference include/Stereo_Iterator.h:16-69)
  - Skew matrix            (reference src/utility.cpp:33-43)
  - Epipolar distances     (reference src/utility.cpp:46-80)
  - Two-ray backprojection (reference src/utility.cpp:95-102)
  - 3D tangent reconstruction via plane intersection (src/utility.cpp:104-112)
  - Tangent projection     (reference src/utility.cpp:114-119)
  - Relative pose          (reference src/utility.cpp:121-126)
  - Linear triangulation   (reference src/utility.cpp:214-339)

All functions operate on trailing-batched arrays (use jax.vmap or give
leading batch dims directly where noted). Everything is float32 by default;
the math is well-conditioned at f32 for VO-scale values.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Pose(NamedTuple):
    """Rigid transform p_target = R @ p_source + t
    (PoseLib-style Camera_Pose, reference include/Stereo_Iterator.h:16-69)."""

    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)

    @staticmethod
    def identity(dtype=jnp.float32) -> "Pose":
        return Pose(jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype))

    def transform(self, p: jnp.ndarray) -> jnp.ndarray:
        """R @ p + t over trailing (..., 3) points."""
        return jnp.einsum("...ij,...j->...i", self.R, p) + self.t

    def rotate(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("...ij,...j->...i", self.R, p)

    def detransform(self, p: jnp.ndarray) -> jnp.ndarray:
        """R^T @ (p - t) (reference Stereo_Iterator.h:55)."""
        return jnp.einsum("...ji,...j->...i", self.R, p - self.t)

    def inverse(self) -> "Pose":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return Pose(Rt, -jnp.einsum("...ij,...j->...i", Rt, self.t))

    def compose(self, other: "Pose") -> "Pose":
        """self . other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.rotate(other.t) + self.t)

    def center(self) -> jnp.ndarray:
        """Camera center in the source frame (reference Stereo_Iterator.h:58)."""
        return -jnp.einsum("...ji,...j->...i", self.R, self.t)


def relative_pose(source: Pose, target: Pose) -> Pose:
    """Relative pose taking source-frame points to target frame
    (reference src/utility.cpp:121-126):
      R_rel = R_t R_s^T ;  t_rel = -R_rel t_s + t_t
    """
    R_rel = target.R @ jnp.swapaxes(source.R, -1, -2)
    t_rel = -jnp.einsum("...ij,...j->...i", R_rel, source.t) + target.t
    return Pose(R_rel, t_rel)


def skew(t: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of (..., 3) vectors (src/utility.cpp:33-43)."""
    z = jnp.zeros_like(t[..., 0])
    rows = jnp.stack(
        [
            jnp.stack([z, -t[..., 2], t[..., 1]], axis=-1),
            jnp.stack([t[..., 2], z, -t[..., 0]], axis=-1),
            jnp.stack([-t[..., 1], t[..., 0], z], axis=-1),
        ],
        axis=-2,
    )
    return rows


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues exp map for (..., 3) -> (..., 3, 3). Single shared
    implementation for the pose-refinement GN (models/motion_tracker.py)
    and the windowed-BA retraction (models/ba.py)."""
    theta = jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    k = w / theta
    kx = skew(k)
    th = theta[..., None]
    I = jnp.eye(3, dtype=w.dtype)
    return I + jnp.sin(th) * kx + (1 - jnp.cos(th)) * (kx @ kx)


def quat_to_R(q: jnp.ndarray) -> jnp.ndarray:
    """(qw, qx, qy, qz) -> rotation matrix; normalizes first."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def R_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qw, qx, qy, qz); host-side numpy (trajectory IO)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


# ---------------------------------------------------------------------------
# Epipolar line geometry
# ---------------------------------------------------------------------------

def epipolar_lines(F: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Epipolar line coefficients l = F @ [x, y, 1] for (..., 2) points
    (reference Stereo_Matches.cpp:10-20). Returns (..., 3).

    Written elementwise on purpose: the obvious
    ``einsum("ij,...j->...i", F, concat([xy, ones]))`` formulation
    has been miscompiled by a backend compiler when F is a closed-over
    constant — the constant column (the `c` coefficient, F @ [0,0,1]) was
    silently dropped,
    which zeroes every epipolar gate downstream. Keep this as scalar
    multiply-adds; do NOT "simplify" back to a matmul.
    """
    x = xy[..., 0]
    y = xy[..., 1]
    a = F[0, 0] * x + F[0, 1] * y + F[0, 2]
    b = F[1, 0] * x + F[1, 1] * y + F[1, 2]
    c = F[2, 0] * x + F[2, 1] * y + F[2, 2]
    return jnp.stack([a, b, c], axis=-1)


def point_line_distance(line: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Perpendicular distance of (..., 2) points to (..., 3) lines
    (reference Stereo_Matches.cpp:91-109)."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    num = jnp.abs(a * xy[..., 0] + b * xy[..., 1] + c)
    return num / jnp.sqrt(a * a + b * b)


def normal_foot_on_line(line: jnp.ndarray, xy: jnp.ndarray):
    """Foot of perpendicular from point to line + distance
    (reference src/utility.cpp:46-54). Returns (foot_xy, dist)."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    s = (a * xy[..., 0] + b * xy[..., 1] + c) / (a * a + b * b)
    foot = jnp.stack([xy[..., 0] - a * s, xy[..., 1] - b * s], axis=-1)
    dist = jnp.linalg.norm(xy - foot, axis=-1)
    return foot, dist


def tangential_intersection_with_line(line: jnp.ndarray, xy: jnp.ndarray, theta: jnp.ndarray):
    """Intersection of the edge tangent line (through xy at angle theta) with
    an epipolar line + displacement (reference src/utility.cpp:63-74).

    Mirrors the reference's tan(theta) parameterization:
      edge line: a2 x + b2 y + c2 = 0 with a2 = tan(theta), b2 = -1.
    Returns (intersection_xy, displacement).
    """
    a2 = jnp.tan(theta)
    b2 = jnp.full_like(a2, -1.0)
    c2 = -(a2 * xy[..., 0] - xy[..., 1])
    a1, b1, c1 = line[..., 0], line[..., 1], line[..., 2]
    den = a1 * b2 - a2 * b1
    xi = (b1 * c2 - b2 * c1) / den
    yi = (c1 * a2 - c2 * a1) / den
    inter = jnp.stack([xi, yi], axis=-1)
    disp = jnp.linalg.norm(inter - xy, axis=-1)
    return inter, disp


# ---------------------------------------------------------------------------
# Backprojection / tangents / triangulation
# ---------------------------------------------------------------------------

def backproject_two_rays(R21: jnp.ndarray, T21: jnp.ndarray,
                         ray1: jnp.ndarray, ray2: jnp.ndarray) -> jnp.ndarray:
    """Closed-form depth from two normalized image rays
    (reference src/utility.cpp:95-102):
      rho1 = (e1.T21 - (e3.T21)(e1.ray2)) / ((e3.(R ray1))(e1.ray2) - e1.(R ray1))
    Returns the 3D point rho1 * ray1 in camera-1 coordinates. Batched over
    leading dims of ray1/ray2 (R21/T21 broadcast).
    """
    Rr1 = jnp.einsum("ij,...j->...i", R21, ray1)
    num = T21[0] - T21[2] * ray2[..., 0]
    den = Rr1[..., 2] * ray2[..., 0] - Rr1[..., 0]
    rho1 = num / den
    return rho1[..., None] * ray1


def reconstruct_3d_tangent(R21: jnp.ndarray, gamma1: jnp.ndarray, gamma2: jnp.ndarray,
                           tangent1: jnp.ndarray, tangent2: jnp.ndarray) -> jnp.ndarray:
    """3D tangent via intersection of interpretation planes
    (reference src/utility.cpp:104-112):
      n1 = t1 x g1 ; n2 = R^T (t2 x g2) ; T = normalize(n1 x n2)
    """
    n1 = jnp.cross(tangent1, gamma1)
    n2 = jnp.einsum("ji,...j->...i", R21, jnp.cross(tangent2, gamma2))
    T = jnp.cross(n1, n2)
    return T / jnp.linalg.norm(T, axis=-1, keepdims=True)


def project_3d_tangent_to_2d(T3d: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
    """Project a 3D tangent onto the image plane at normalized point gamma
    (reference src/utility.cpp:114-119): t = normalize(T - T_z * gamma)."""
    t = T3d - T3d[..., 2:3] * gamma
    return t / jnp.linalg.norm(t, axis=-1, keepdims=True)


def pixel_to_ray(K_inv: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """K^-1 [x, y, 1] for (..., 2) pixel coords -> (..., 3) rays."""
    ones = jnp.ones_like(xy[..., :1])
    return jnp.einsum("ij,...j->...i", K_inv, jnp.concatenate([xy, ones], axis=-1))


def theta_to_ray_tangent(K_inv: jnp.ndarray, theta: jnp.ndarray) -> jnp.ndarray:
    """K^-1 [cos t, sin t, 0] (reference src/MotionTracker.cpp:50-53)."""
    t = jnp.stack([jnp.cos(theta), jnp.sin(theta), jnp.zeros_like(theta)], axis=-1)
    return jnp.einsum("ij,...j->...i", K_inv, t)


def project(K: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Pinhole projection of (..., 3) camera points -> (..., 2) pixels."""
    uvw = jnp.einsum("ij,...j->...i", K, p)
    return uvw[..., :2] / uvw[..., 2:3]


def two_view_linear_triangulation(gamma1_px: jnp.ndarray, gamma2_px: jnp.ndarray,
                                  K1_inv: jnp.ndarray, K2_inv: jnp.ndarray,
                                  R: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
    """SVD-free linear two-view triangulation (reference src/utility.cpp:214-265).

    The reference builds the 4x4 DLT system A and takes the null vector of
    A^T A via Jacobi SVD. Here we solve the equivalent inhomogeneous 3x3
    normal system for the finite point (last coordinate fixed to 1), which
    is algebraically identical for non-degenerate geometry and maps to
    batched dense linear algebra on the device.
    Inputs are (..., 2) pixel coordinates.
    """
    g1 = pixel_to_ray(K1_inv, gamma1_px)
    g2 = pixel_to_ray(K2_inv, gamma2_px)
    zeros = jnp.zeros_like(g1[..., 0])

    def rows_cam1():
        r0 = jnp.stack([zeros, -jnp.ones_like(zeros), g1[..., 1], zeros], axis=-1)
        r1 = jnp.stack([jnp.ones_like(zeros), zeros, -g1[..., 0], zeros], axis=-1)
        return r0, r1

    def rows_cam2():
        y2, x2 = g2[..., 1], g2[..., 0]
        r2 = jnp.stack(
            [y2 * R[2, 0] - R[1, 0], y2 * R[2, 1] - R[1, 1],
             y2 * R[2, 2] - R[1, 2], y2 * T[2] - T[1]], axis=-1)
        r3 = jnp.stack(
            [R[0, 0] - x2 * R[2, 0], R[0, 1] - x2 * R[2, 1],
             R[0, 2] - x2 * R[2, 2], T[0] - x2 * T[2]], axis=-1)
        return r2, r3

    r0, r1 = rows_cam1()
    r2, r3 = rows_cam2()
    A = jnp.stack([r0, r1, r2, r3], axis=-2)  # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = jnp.einsum("...ki,...kj->...ij", M, M)
    Atb = jnp.einsum("...ki,...k->...i", M, b)
    return jnp.linalg.solve(AtA, Atb)


def multiview_linear_triangulation(pts_px: jnp.ndarray, Rs: jnp.ndarray, Ts: jnp.ndarray,
                                   K_inv: jnp.ndarray) -> jnp.ndarray:
    """N-view linear triangulation (reference src/utility.cpp:267-339).

    pts_px: (N, 2) pixel points; Rs/Ts: (N-1, 3, 3)/(N-1, 3) poses of views
    2..N relative to view 1 (view 1 assumed identity). Returns (3,) point in
    view-1 coordinates. Solves the inhomogeneous normal equations like
    `two_view_linear_triangulation`.
    """
    g = pixel_to_ray(K_inv, pts_px)  # (N, 3)
    z = jnp.zeros(())
    one = jnp.ones(())
    rows = [
        jnp.stack([z, -one, g[0, 1], z]),
        jnp.stack([one, z, -g[0, 0], z]),
    ]
    n_extra = Rs.shape[0]
    for p in range(n_extra):
        Rp, Tp, mp = Rs[p], Ts[p], g[p + 1]
        rows.append(jnp.stack([mp[1] * Rp[2, 0] - Rp[1, 0], mp[1] * Rp[2, 1] - Rp[1, 1],
                               mp[1] * Rp[2, 2] - Rp[1, 2], mp[1] * Tp[2] - Tp[1]]))
        rows.append(jnp.stack([Rp[0, 0] - mp[0] * Rp[2, 0], Rp[0, 1] - mp[0] * Rp[2, 1],
                               Rp[0, 2] - mp[0] * Rp[2, 2], Tp[0] - mp[0] * Tp[2]]))
    A = jnp.stack(rows, axis=0)
    M, b = A[:, :3], -A[:, 3]
    return jnp.linalg.solve(M.T @ M, M.T @ b)


# ---------------------------------------------------------------------------
# Angle helpers (reference include/utility.h:287-297 + wrap idioms)
# ---------------------------------------------------------------------------

def rad2deg(x):
    return x * (180.0 / jnp.pi)


def deg2rad(x):
    return x * (jnp.pi / 180.0)


def orientation_diff_deg(theta1, theta2):
    """|theta1 - theta2| in degrees wrapped to [0, 180]
    (reference Stereo_Matches.cpp:887-889)."""
    d = jnp.abs(rad2deg(theta1 - theta2)) % 360.0
    return jnp.where(d > 180.0, 360.0 - d, d)


def orientation_gate(diff_deg, thresh_deg):
    """Pass if diff < t or |diff - 180| < t (reference Stereo_Matches.cpp:901)."""
    return (diff_deg < thresh_deg) | (jnp.abs(diff_deg - 180.0) < thresh_deg)
