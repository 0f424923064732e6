"""Separable blur of many images (port of gslivm_tpu/ops/blur_pallas.py).

`blur_many(x [N, H, W], taps)` is the zero-padded SAME separable
correlation of every [H, W] slice with the taps on both axes — exactly
`blur_plain`, the shift-add chain of `losses._gaussian_blur_shift_add`.
CUDA tensors go through the hand-written kernel K3 (`csrc/blur.cu`); CPU
tensors take `blur_plain`. The blur is linear in x, so its VJP is the same
blur with the taps REVERSED (the adjoint of a correlation), through the
same kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels


def blur_plain(x, taps):
    """Zero-padded SAME separable correlation by shift-and-add: the plain
    PyTorch version of K3 (losses.py:76-93 in the JAX package)."""
    k = len(taps)
    r = k // 2
    N, H, W = x.shape
    xp = F.pad(x, (r, r))
    out = sum(float(taps[i]) * xp[:, :, i:i + W] for i in range(k))
    xp = F.pad(out, (0, 0, r, r))
    return sum(float(taps[i]) * xp[:, i:i + H, :] for i in range(k))


def blur_cuda(x, taps):
    """K3 wrapper: one launch on the current stream for all N slices."""
    if (not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 [N, H, W] CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    k = len(taps)
    if not 1 <= k <= 15:
        raise ValueError(f"K3 takes 1..15 taps, got {k}")
    y = torch.empty_like(x)
    host_taps = (ctypes.c_float * k)(*(float(t) for t in taps))
    fn = kernels.library("blur")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
                 ctypes.cast(host_taps, ctypes.c_void_p), k,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"blur kernel launch failed: CUDA error {err}")
    blur_cuda.launches += 1
    return y


blur_cuda.launches = 0  # K3 launches since the last reset


def _blur_impl(x, taps):
    return blur_cuda(x.contiguous(), taps) if x.is_cuda else blur_plain(x, taps)


class _BlurMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = taps
        return _blur_impl(x, taps)

    @staticmethod
    def backward(ctx, g):
        # adjoint of zero-padded SAME correlation = same blur, reversed taps
        return _blur_impl(g, tuple(reversed(ctx.taps))), None


def blur_many(x, taps):
    """Blur each [H, W] slice of x [N, H, W] with the separable taps
    (a sequence of floats). Differentiable in x."""
    return _BlurMany.apply(x, tuple(float(t) for t in taps))
