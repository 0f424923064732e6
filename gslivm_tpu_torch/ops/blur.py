"""Separable blur of many images (port of gslivm_tpu/ops/blur_pallas.py).

`blur_many(x [N, H, W], taps)` is the zero-padded SAME separable
correlation of every [H, W] slice with the taps on both axes — exactly
`blur_plain`, the shift-add chain of `losses._gaussian_blur_shift_add`.
CUDA tensors go through the hand-written kernel K3 (`csrc/blur.cu`, tiled
in float4 or scalar rows and strips of rows as `float4_rows` and
`strip_rows` choose); CPU tensors take `blur_plain`. The blur is linear
in x, so its VJP is the same blur with the taps REVERSED (the adjoint of a
correlation), through the same kernel.
"""

from __future__ import annotations

import ctypes
import functools

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


# K3's block: 128 threads of 4 adjacent columns each (csrc/blur.cu)
BLOCK_COLS = 512
# the output rows a block may walk, shortest first
STRIPS = (32, 64, 128)


def float4_rows(w: int, x_ptr: int, y_ptr: int) -> bool:
    """Whether K3 takes its float4 instantiation: rows of a multiple of 4
    floats and both pointers 16-byte aligned. Any other shape or view takes
    the scalar one."""
    return w % 4 == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0


def strip_rows(n: int, h: int, w: int, resident: int) -> int:
    """The output rows each K3 block walks for an [n, h, w] stack: the
    shortest of STRIPS whose grid of (column blocks, strips, slices) fits in
    one wave of the `resident` blocks the card holds at once (blocks per SM
    times SMs), else the tallest; never taller than the image. Shorter
    strips put more blocks, and so more rows of loads, in flight; a grid
    past one wave leaves a tail of blocks that start late."""
    cols = -(-w // BLOCK_COLS)
    strip = next((s for s in STRIPS if n * cols * -(-h // s) <= resident), STRIPS[-1])
    return max(1, min(strip, h))


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int, k: int, vec: bool) -> int:
    """The K3 blocks (k taps, float4 or scalar) that card `device_index`
    holds at once, from the CUDA runtime's report (kernels.usage)."""
    with torch.cuda.device(device_index):
        per_sm = kernels.usage("blur", k, int(vec))["blocks_per_sm"]
        return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


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
    n, h, w = x.shape
    vec = float4_rows(w, x.data_ptr(), y.data_ptr())
    strip = strip_rows(n, h, w, resident_blocks(x.device.index, k, vec))
    host_taps = (ctypes.c_float * k)(*(float(t) for t in taps))
    fn = kernels.library("blur")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), n, h, w,
                 ctypes.cast(host_taps, ctypes.c_void_p), k, int(vec), strip,
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
