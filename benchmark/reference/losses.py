"""Plain reference losses of the mapper's step and the PSNR score.

Frozen copies of the semantics of `gslivm_tpu_torch/ops/losses.py`
(L1; SSIM with the reference's asymmetric 11-tap window
exp(-floor((x - 11)/2)^2 / 2 sigma^2), zero-padded SAME, per channel;
PSNR as 20 log10(1 / sqrt(mse)) per channel, then the mean; inverse
depth) and of `models/training.py` (the structural similarity loss
against the LiDAR anchors, the delta-depth warp between history pairs),
in plain torch in any float dtype. The blur is a separable convolution
(`F.conv1d`), never the program's kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1, C2 = 0.01**2, 0.03**2


def l1(pred, gt):
    return torch.abs(pred - gt).mean()


def window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64)
    g = np.exp(-(np.floor((x - size) / 2.0) ** 2) / (2.0 * sigma * sigma))
    return g / g.sum()


def blur(x, taps: np.ndarray):
    """Separable zero-padded SAME correlation of [C, H, W] with the taps,
    along W then along H (the 2-D window is their outer product)."""
    k = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    r = len(taps) // 2
    C, H, W = x.shape
    rows = F.conv1d(x.reshape(C * H, 1, W), k.reshape(1, 1, -1), padding=r)
    rows = rows.reshape(C, H, W).transpose(1, 2).reshape(C * W, 1, H)
    cols = F.conv1d(rows, k.reshape(1, 1, -1), padding=r)
    return cols.reshape(C, W, H).transpose(1, 2)


def ssim(img1, img2):
    taps = window()
    mu1, mu2 = blur(img1, taps), blur(img2, taps)
    s11 = blur(img1 * img1, taps) - mu1 * mu1
    s22 = blur(img2 * img2, taps) - mu2 * mu2
    s12 = blur(img1 * img2, taps) - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def psnr(pred, gt):
    """Mean over channels of 20 log10(1 / sqrt(mse)) (the mapper's and
    quality_bench's PSNR arithmetic)."""
    mse = ((pred - gt) ** 2).reshape(pred.shape[0], -1).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


def inv_depth(depth, eps: float = 1e-2):
    inv = 1.0 / torch.clamp(depth, min=eps)
    return torch.where(depth <= eps, torch.zeros_like(inv), inv)


def simi(xyz, log_scale, points, gauss_idx):
    """Mean over the anchor points of the distance to the nearest gaussian
    'sphere' surface, the radius the mean of the selected gaussians'
    activated scales (calcSimiLoss); points [M, 3], gauss_idx [G] long."""
    if len(points) == 0 or len(gauss_idx) == 0:
        return xyz.sum() * 0.0
    x = xyz[gauss_idx]
    radius = torch.exp(log_scale[gauss_idx]).mean()
    d = torch.linalg.norm(points[:, None, :] - x[None], dim=-1)
    return torch.clamp(d - radius, min=0.0).amin(dim=1).mean()


def delta_depth(depth_a, acc_a, view_a, depth_b, acc_b, view_b):
    """The inverse-depth gap between view a's rendered depth warped into
    view b and view b's rendered depth, where both silhouettes are >= 0.5
    (bilinear, align_corners, zero outside)."""
    H, W = depth_a.shape
    dt, dev = depth_a.dtype, depth_a.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev), indexing="ij")
    K = view_a.K
    d = depth_a.reshape(-1)
    pts = torch.stack([(xs.reshape(-1) - K[0, 2]) / K[0, 0] * d,
                       (ys.reshape(-1) - K[1, 2]) / K[1, 1] * d, d], 0)
    R = view_b.R_cw @ view_a.R_cw.T
    t = view_b.R_cw @ view_a.center + view_b.t_cw
    proj = R @ pts + t[:, None]
    uvw = view_b.K @ proj
    u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
    src = proj[2].reshape(H, W)
    ok = (u > -1.0) & (u < W) & (v > -1.0) & (v < H)
    gx = torch.where(ok, u / (W - 1) * 2 - 1, torch.full_like(u, -3.0))
    gy = torch.where(ok, v / (H - 1) * 2 - 1, torch.full_like(v, -3.0))
    grid = torch.stack([gx, gy], -1).reshape(1, H, W, 2)
    warped = F.grid_sample(src[None, None], grid, mode="bilinear", padding_mode="zeros",
                           align_corners=True)[0, 0]
    warped = torch.where(ok.reshape(H, W), warped, torch.zeros_like(warped))
    mask = ((acc_a >= 0.5) & (acc_b >= 0.5)).to(dt)
    return torch.abs(inv_depth(warped) * mask - inv_depth(depth_b) * mask).mean()
