"""Gaussian covariance math (port of gslivm_tpu/ops/covariance.py).

Behavioral spec: reference `src/cuda_rasterizer/forward.cu`:
  - computeCov3D (forward.cu:138-176): Sigma = R diag(s^2) R^T from the RAW
    quaternion WITHOUT normalization (forward.cu:146).
  - computeCov2D (forward.cu:79-133): EWA projection with the 1.3*tan(fov)
    frustum clamp and the +0.3 pixel low-pass on the 2D diagonal.
  - conic/radius (forward.cu:250-263): inverse 2D covariance, 3-sigma
    radius with the sqrt(max(0.1, ...)) eigenvalue clamp.

Written as explicit channel arithmetic in the same order as the JAX
package, so both round alike.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q):
    """Quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3].

    Deliberately does NOT normalize q (forward.cu:146).
    """
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)],
        dim=-1,
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)],
        dim=-1,
    )
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)],
        dim=-1,
    )
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov3d(scales, quats, scale_modifier=1.0):
    """Scale+quat -> symmetric world covariance, packed [..., 6] in the
    order (xx, xy, xz, yy, yz, zz) of forward.cu:170-175."""
    R = quat_to_rotmat(quats)
    s2 = (scale_modifier * scales) ** 2
    r0, r1, r2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]

    def dot_s2(a, b):
        return (a * s2 * b).sum(dim=-1)

    return torch.stack(
        [dot_s2(r0, r0), dot_s2(r0, r1), dot_s2(r0, r2),
         dot_s2(r1, r1), dot_s2(r1, r2), dot_s2(r2, r2)],
        dim=-1,
    )


def unpack_cov3d(cov6):
    """[..., 6] packed -> [..., 3, 3] symmetric matrix."""
    c0, c1, c2, c3, c4, c5 = (cov6[..., i] for i in range(6))
    row0 = torch.stack([c0, c1, c2], dim=-1)
    row1 = torch.stack([c1, c3, c4], dim=-1)
    row2 = torch.stack([c2, c4, c5], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov2d(mean_view, cov3d6, R_cw, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA projection of the world covariance (forward.cu:79-133).

    mean_view: [..., 3] center in the CAMERA frame; cov3d6: [..., 6];
    R_cw: [3, 3]; focals in pixels; half-FoV tangents.
    Returns [..., 3] packed (a, b, c) with the +0.3 low-pass added.
    """
    # culled slots can sit at tz ~ 0: clamp the divisor so inf never enters
    # the gradient graph (only slots the valid mask excludes are affected)
    tz = mean_view[..., 2]
    tz = torch.where(torch.abs(tz) > 1e-6, tz, torch.full_like(tz, 1e-6))
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(mean_view[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(mean_view[..., 1] / tz, -limy, limy) * tz

    # J rows: j0 = (fx/tz, 0, -fx*tx/tz^2), j1 = (0, fy/tz, -fy*ty/tz^2)
    inv_z = 1.0 / tz
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z

    # rows of T = J @ R_cw
    t0 = [j00 * R_cw[0, i] + j02 * R_cw[2, i] for i in range(3)]
    t1 = [j11 * R_cw[1, i] + j12 * R_cw[2, i] for i in range(3)]

    c0, c1, c2, c3, c4, c5 = (cov3d6[..., i] for i in range(6))

    def vrk_dot(u):  # Vrk @ u for symmetric packed Vrk
        return (
            c0 * u[0] + c1 * u[1] + c2 * u[2],
            c1 * u[0] + c3 * u[1] + c4 * u[2],
            c2 * u[0] + c4 * u[1] + c5 * u[2],
        )

    v0 = vrk_dot(t0)
    v1 = vrk_dot(t1)
    a = t0[0] * v0[0] + t0[1] * v0[1] + t0[2] * v0[2] + 0.3
    b = t0[0] * v1[0] + t0[1] * v1[1] + t0[2] * v1[2]
    c = t1[0] * v1[0] + t1[1] * v1[1] + t1[2] * v1[2] + 0.3
    return torch.stack([a, b, c], dim=-1)


def conic_and_radius(cov2d):
    """Inverse 2D covariance and the 3-sigma pixel radius (forward.cu:250-263).

    Returns (conic [..., 3], radius [...], det [...]); det == 0 marks a
    degenerate gaussian that the caller culls.
    """
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    nonzero = det != 0.0
    # safe-where: divide by a nonzero stand-in so the zero branch does not
    # produce inf whose gradient (0 * inf) poisons culled slots
    det_inv = torch.where(
        nonzero, 1.0 / torch.where(nonzero, det, torch.ones_like(det)),
        torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))
    return conic, radius, det


def scale_abnormal(scales, scale_modifier=1.0, limit=0.3):
    """Oversize-scale cull mask (forward.cu:19-25): True -> cull."""
    s = scale_modifier * scales
    return torch.any(s > limit, dim=-1)
