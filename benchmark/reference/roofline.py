"""The work of the hand-written kernels, counted from the inputs by the
reference, and the card's peaks.

Operations per (gaussian, pixel) pair (copied with their derivation from
the bring-up smoke's kernel table): K1 evaluates a pair with dx, dy (2),
the conic quadratic (9), exp (counted 2), alpha and its tests (2): 15.
K2 evaluates every pair once as K1 does (15) and, for each contributing
pair, forms psi (7), dL/dalpha (6), d opacity and d power (3), u and v (2)
and adds 10 gradient terms (12 more products): 30 more.

The pairs are those any correct compositor must evaluate: alpha >= 1/255
while the pixel's transmittance has not stopped (`raster.render`'s
count), so neither tiling, binning nor early termination moves the
yardstick. Bytes count each input byte read once and each output byte
written once:

- K1 reads 10 floats a visible gaussian (mean2d 2, conic 3, opacity 1,
  colour 3, depth 1) and writes colour 3, depth 1, silhouette 1 and final
  transmittance 1 a pixel;
- K2 reads the same 10 floats a gaussian and dL/dcolour 3, dL/dsilhouette
  1 and the final transmittance 1 a pixel, and writes 9 gradient floats a
  gaussian (mean2d 2, conic 3, opacity 1, colour 3);
- K3 reads and writes its stack once: an SSIM against cached ground-truth
  statistics blurs 9 channels (the render, its square, its product with
  the ground truth) forward and 9 backward, a camera.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores
# and HBM3 bytes/s
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
K1_OPS_PER_PAIR = 15
K2_OPS_PER_PAIR = 15 + 30
F32 = 4


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def k1_bound_s(pairs: int, visible: int, pixels: int) -> float:
    return bound_s(K1_OPS_PER_PAIR * pairs, F32 * (10 * visible + 6 * pixels))


def k2_bound_s(pairs: int, visible: int, pixels: int) -> float:
    return bound_s(K2_OPS_PER_PAIR * pairs, F32 * (19 * visible + 5 * pixels))


def k3_bound_s(channels: int, pixels: int) -> float:
    """A blur of a [channels, H, W] stack, pixels = H * W."""
    return bound_s(0, F32 * 2 * channels * pixels)
