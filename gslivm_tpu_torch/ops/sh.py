"""Spherical-harmonics color evaluation (port of gslivm_tpu/ops/sh.py).

Behavioral spec: reference `src/cuda_rasterizer/forward.cu:29-76`
(computeColorFromSH) and `include/gs/gs/sh_utils.cuh:61-63` (RGB2SH).
Per Gaussian, `sh[K, 3]` with K = (deg+1)^2; band 0 is the DC term. The
clamp (color < 0 -> 0) is differentiated by autograd.
"""

from __future__ import annotations

import torch

# auxiliary.h:21-33 (the standard real-SH band constants)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def rgb_to_sh(rgb):
    """RGB in [0,1] -> band-0 SH coefficient (sh_utils.cuh:61-63)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh_dc):
    return sh_dc * SH_C0 + 0.5


def eval_sh(sh, dirs, degree: int):
    """Evaluate SH -> raw RGB (before the +0.5 shift and clamp).

    sh: [..., K, 3], K >= (degree+1)^2; dirs: [..., 3] unit directions;
    degree in [0, 3]. Returns [..., 3].
    """
    result = SH_C0 * sh[..., 0, :]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1, :]
            + SH_C1 * z * sh[..., 2, :]
            - SH_C1 * x * sh[..., 3, :]
        )
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_color(sh, means, campos, degree: int):
    """Full SH -> clamped RGB pipeline of forward.cu:29-76.

    sh [..., K, 3], means [..., 3], campos [3] -> [..., 3] color >= 0.
    """
    dirs = means - campos
    # clip the norm: padded/degenerate slots can sit exactly at the camera
    # center, and 0/0 here would poison gradients through masks downstream
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clip(min=1e-12)
    raw = eval_sh(sh, dirs, degree) + 0.5
    return torch.clamp(raw, min=0.0)
