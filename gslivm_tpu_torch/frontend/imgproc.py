"""OpenCV's resize and undistortion of uint8 images, without OpenCV (the
camera intake of imageProcessing.cpp:114-135), as integer tensor ops on
the caller's device.

  - `resize_linear(img, (w, h))` is `cv2.resize(img, (w, h))`
    (INTER_LINEAR) bit for bit: at exactly half size in both axes OpenCV
    takes its 2x2 area path, `(a + b + c + d + 2) >> 2`; otherwise its
    fixed-point bilinear path, 11-bit weights from float32 source positions,
    the horizontal pass in int32 and the vertical pass as
    `((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2`.
  - `undistort_rectify_map(K, dist, (w, h))` is
    `cv2.initUndistortRectifyMap(K, dist, None, K, (w, h), CV_16SC2)`,
    computed in float64 on the host: int16 (x, y) integer parts and the
    uint16 index of the 1/32-pixel fraction into the 32 x 32 table.
  - `remap_linear(img, maps)` is `cv2.remap(img, *maps, INTER_LINEAR)` with
    BORDER_CONSTANT 0: each tap outside the image reads 0, and the four
    15-bit weights of the table sum with `(s + (1 << 14)) >> 15`.
"""

from __future__ import annotations

import numpy as np
import torch

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
RESIZE_COEF_SCALE = 1 << 11


def _linear_coeffs(dst: int, src: int, clamp: bool):
    """cv::resize's two source indices and 11-bit weights along one axis.
    Columns past an edge take the edge pixel at full weight (`clamp`); rows
    keep their fractional weights and read the edge row twice."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        f[(s < 0) | (s >= src - 1)] = 0
        s = np.clip(s, 0, src - 1)
    a1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    a0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def _is_half(dst: int, src: int) -> bool:
    scale = 1.0 / (dst / src)
    return round(scale) == 2 and abs(scale - 2) < np.finfo(np.float64).eps


def resize_linear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[H, W, C] uint8 -> [h, w, C] uint8 for size = (w, h), as
    cv2.resize(img, size) with INTER_LINEAR."""
    w, h = size
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.clone()
    if _is_half(w, W) and _is_half(h, H):
        x = img.to(torch.int32)
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    dev = img.device
    x0, x1, a0, a1 = (torch.as_tensor(v, device=dev) for v in _linear_coeffs(w, W, True))
    y0, y1, b0, b1 = (torch.as_tensor(v, device=dev) for v in _linear_coeffs(h, H, False))
    x = img.to(torch.int32)
    rows = x[:, x0] * a0[:, None] + x[:, x1] * a1[:, None]      # [H, w, C]
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    out = ((b0[:, None, None] * s0) >> 16) + ((b1[:, None, None] * s1) >> 16)
    return ((out + 2) >> 2).to(torch.uint8)


def undistort_rectify_map(K, dist, size: tuple[int, int]):
    """cv2.initUndistortRectifyMap(K, dist, None, K, size, CV_16SC2) for a
    pinhole K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]] and OpenCV's 4, 5 or
    8 radial-tangential coefficients: (xy [h, w, 2] int16, fxy [h, w]
    uint16) numpy arrays."""
    K = np.asarray(K, np.float64)
    d = np.zeros(8)
    d[:len(np.ravel(dist))] = np.ravel(dist)
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # the LU inverse of the new camera matrix K, as OpenCV's solver forms it
    ir0, ir2, ir4, ir5 = 1.0 / fx, -u0 / fx, 1.0 / fy, -v0 / fy
    w, h = size
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    x = i * 0.0 + ir2 + j * ir0
    y = i * ir4 + ir5 + j * 0.0
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    u = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + v0
    iu = np.rint(u * INTER_TAB_SIZE).astype(np.int64)
    iv = np.rint(v * INTER_TAB_SIZE).astype(np.int64)
    xy = np.stack([iu >> INTER_BITS, iv >> INTER_BITS], -1).astype(np.int16)
    fxy = ((iv & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
           + (iu & (INTER_TAB_SIZE - 1))).astype(np.uint16)
    return xy, fxy


def remap_linear(img: torch.Tensor, xy: torch.Tensor, fxy: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, xy, fxy, INTER_LINEAR) with BORDER_CONSTANT 0 on a
    [H, W, C] uint8 image and CV_16SC2 maps (tensors on the image's
    device) -> [h, w, C] uint8."""
    H, W = img.shape[:2]
    x = img.to(torch.int32)
    sx, sy = xy[..., 0].to(torch.int64), xy[..., 1].to(torch.int64)
    f = fxy.to(torch.int32)
    ax, ay = f & (INTER_TAB_SIZE - 1), f >> INTER_BITS
    total = 0
    for dy, wy in ((0, INTER_TAB_SIZE - ay), (1, ay)):
        for dx, wx in ((0, INTER_TAB_SIZE - ax), (1, ax)):
            tx, ty = sx + dx, sy + dy
            inside = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
            tap = x[ty.clamp(0, H - 1), tx.clamp(0, W - 1)] * inside[..., None]
            total = total + tap * (wy * wx * INTER_TAB_SIZE)[..., None]
    return ((total + (1 << 14)) >> 15).to(torch.uint8)
