"""Photometric losses: L1, SSIM, PSNR, inverse depth (port of
gslivm_tpu/ops/losses.py).

Behavioral spec: reference `include/gs/gs/loss_utils.cuh`:
  - l1_loss (11-13); inv_depth (15-21): 1/clamp(depth, eps), depth<=eps -> 0.
  - gaussian window (24-30): the reference builds the 11-tap window as
    exp(-floor((x - window_size)/2)^2 / (2 sigma^2)) — an ASYMMETRIC window
    (an integer-division quirk); reproduced for parity.
  - ssim (43-70): 11x11, sigma=1.5, per-channel, zero-padded SAME.
  - psnr (89-93): 20*log10(1/sqrt(mse)), mse per channel, then the mean.

Images are channel-first [C, H, W] float32 in [0, 1]. Every blur runs in
full float32: through K3 on the card, the plain shift-add on the CPU —
never through a TF32 convolution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .blur import blur_many, blur_plain

_C1 = 0.01**2
_C2 = 0.03**2


def l1_loss(pred, gt):
    return torch.abs(pred - gt).mean()


def inv_depth(depth, epsilon: float = 1e-2):
    """loss_utils.cuh:15-21."""
    inverse = 1.0 / torch.clamp(depth, min=epsilon)
    return torch.where(depth <= epsilon, torch.zeros_like(inverse), inverse)


def gaussian_1d(window_size: int = 11, sigma: float = 1.5, symmetric: bool = False):
    """1D normalized gaussian taps (loss_utils.cuh:24-30) as a float32 numpy
    array. symmetric=False reproduces the reference's floor((x - ws)/2)
    exponent."""
    x = np.arange(window_size, dtype=np.float64)
    if symmetric:
        g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma * sigma))
    else:
        g = np.exp(-(np.floor((x - window_size) / 2.0) ** 2) / (2.0 * sigma * sigma))
    g = g / g.sum()
    return g.astype(np.float32)


# the plain blur of [C, H, W] by shift-and-add, in the JAX package's
# summation order (K3's plain version)
_gaussian_blur_shift_add = blur_plain


def _blur_parts(parts, taps: np.ndarray):
    """Blur several same-shaped [C, H, W] fields with shared taps: the parts
    are stacked into ONE blur_many call (one K3 launch on the card)."""
    out = blur_many(torch.cat(parts, dim=0), taps)
    return list(torch.split(out, [p.shape[0] for p in parts], dim=0))


def ssim_ref_stats(img2, window_size: int = 11, sigma: float = 1.5,
                   symmetric_window: bool = False):
    """The REFERENCE-side SSIM statistics (mu2, sigma2_sq) of img2, for
    reuse across many `ssim` calls against the same image."""
    taps = gaussian_1d(window_size, sigma, symmetric_window)
    mu2, m22 = _blur_parts([img2, img2 * img2], taps)
    return mu2, m22 - mu2 * mu2


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         symmetric_window: bool = False, ref_stats=None):
    """Mean SSIM over the image (loss_utils.cuh:43-70). Inputs [C, H, W].

    ref_stats: optional (mu2, sigma2_sq) from ssim_ref_stats of THIS img2
    with the same window.
    """
    taps = gaussian_1d(window_size, sigma, symmetric_window)
    if ref_stats is None:
        mu1, mu2, m11, m22, m12 = _blur_parts(
            [img1, img2, img1 * img1, img2 * img2, img1 * img2], taps)
        sigma2_sq = m22 - mu2 * mu2
    else:
        mu2, sigma2_sq = ref_stats
        mu1, m11, m12 = _blur_parts([img1, img1 * img1, img1 * img2], taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma12 = m12 - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + _C1) * (2.0 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    return ssim_map.mean()


def _rows_with_halo(x, lo: int, hi: int):
    """Rows [lo, hi) of x [C, H, W], zero outside [0, H)."""
    H = x.shape[1]
    inner = x[:, min(max(lo, 0), H):min(max(hi, 0), H)]
    return F.pad(inner, (0, 0, min(max(-lo, 0), hi - lo), max(hi - max(lo, H), 0)))


def ssim_band_sum(img1, img2, row_lo: int, n_rows: int, window_size: int = 11,
                  sigma: float = 1.5, symmetric_window: bool = False):
    """SUM of the SSIM map over image rows [row_lo, row_lo + n_rows).

    The pixel-sharded loss building block: each rank of a "pixel" axis
    blurs only its band plus the window radius of halo rows (zero outside
    the image, the neighbourhood of `ssim`'s zero-padded SAME blur), and
    the full-image mean is the sum of the band sums over C*H*W. Rows at or
    beyond H contribute nothing. On the card the five blurs are one K3
    launch, as in `ssim`."""
    taps = gaussian_1d(window_size, sigma, symmetric_window)
    r = window_size // 2
    H = img1.shape[1]
    row_lo = min(max(int(row_lo), 0), H)
    a = _rows_with_halo(img1, row_lo - r, row_lo + n_rows + r)
    b = _rows_with_halo(img2, row_lo - r, row_lo + n_rows + r)
    mu1, mu2, m11, m22, m12 = _blur_parts([a, b, a * a, b * b, a * b], taps)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = m11 - mu1_sq
    sigma2_sq = m22 - mu2_sq
    sigma12 = m12 - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + _C1) * (2.0 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    return ssim_map[:, r:r + min(n_rows, H - row_lo)].sum()


def l1_band_sum(img1, img2, row_lo: int, n_rows: int):
    """SUM of |img1 - img2| over image rows [row_lo, row_lo + n_rows), the
    sibling of ssim_band_sum; rows at or beyond H contribute nothing."""
    lo = min(max(int(row_lo), 0), img1.shape[1])
    return torch.abs(img1[:, lo:lo + n_rows] - img2[:, lo:lo + n_rows]).sum()


def psnr(pred, gt):
    """loss_utils.cuh:89-93. Inputs [C, H, W] in [0, 1]."""
    mse = ((pred - gt) ** 2).reshape(pred.shape[0], -1).mean(dim=1)
    return (20.0 * torch.log10(1.0 / torch.sqrt(mse))).mean()


def image_loss(pred, gt, lambda_dssim: float = 0.2):
    """The training image loss (lioOptimization.cpp:1705-1712):
    (1 - lambda) * L1 + lambda * (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def smooth_depth(depth):
    """loss_utils.cuh:73-87: |3x3-gaussian-smoothed depth - depth| mean.

    The 3x3 window [[1,2,1],[2,4,2],[1,2,1]]/16 is the outer product of the
    taps [1/4, 1/2, 1/4] (every product exact in f32), so the zero-padded
    SAME smoothing is one separable blur_many call: K3 on the card.
    """
    taps = np.asarray([0.25, 0.5, 0.25], np.float32)
    sm = blur_many(depth[None], taps)[0]
    return torch.abs(sm - depth).mean()
