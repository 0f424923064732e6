"""The plain reference of the mapper's GP ingest, held against the rows a
frame appended to the map.

- Centres: each appended centre is the centre of a valid cell of one of
  the GP's outputs that its frame or an earlier one made (the program
  keeps cells that no camera has seen yet in a pool), bit for bit.
- Colour and append: the program colourises each appended gaussian at the
  nearest pixel of the frame's image through the frame's camera
  (truncation toward zero, no distortion) and stores it as the SH band-0
  coefficient (rgb / 255 - 0.5) / C0. The reference projects the same
  centres through the same camera and reads the same image.
"""

from __future__ import annotations

import numpy as np
import torch

from .raster import SH_C0


def appended_rgb(dc) -> torch.Tensor:
    """The 8-bit colour a band-0 SH coefficient [M, 1, 3] or [M, 3] stores."""
    return (dc.reshape(-1, 3).double() * SH_C0 + 0.5) * 255.0


def colours(xyz, R_wc, center, fx: float, fy: float, image):
    """(colour [M, 3] in 8-bit levels, inside [M]) of centres [M, 3] at the
    nearest pixel of `image` through the camera (R_wc, centre), computed in
    xyz's dtype; the principal point is the image's centre."""
    H, W = image.shape[:2]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    dev, dt = xyz.device, xyz.dtype
    R = torch.as_tensor(np.asarray(R_wc), device=dev).to(dt)
    c = torch.as_tensor(np.asarray(center), device=dev).to(dt)
    p = (xyz - c) @ R
    z = torch.where(p[:, 2] != 0, p[:, 2], torch.ones_like(p[:, 2]))
    u = torch.trunc(fx * p[:, 0] / z + cx).double()
    v = torch.trunc(fy * p[:, 1] / z + cy).double()
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    img = torch.as_tensor(np.asarray(image), device=dev)
    rgb = img[v.clamp(0, H - 1).long(), u.clamp(0, W - 1).long()].double()
    return torch.where(ok[:, None], rgb, torch.full_like(rgb, float("nan")))


def colour_gap(xyz, rgb, R_wc, center, fx: float, fy: float, image) -> tuple[float, int]:
    """(sum of |rgb - reference| over the rows' channels in 8-bit levels,
    the rows compared), the reference in float64; a row whose centre falls
    outside the image, which no camera colourised, counts 255 a channel."""
    ref = colours(xyz.double(), R_wc, center, fx, fy, image)
    gap = torch.nan_to_num((rgb.double() - ref).abs(), nan=255.0)
    return float(gap.sum()), int(xyz.shape[0])


def unmatched_rows(xyz, centres) -> int:
    """How many rows of xyz [M, 3] (float32) are, bit for bit, no row of any
    of the tensors in `centres` (each [K, 3] float32)."""
    pool = torch.cat([c.to(xyz.device) for c in centres]).contiguous().view(torch.int32)
    rows = xyz.contiguous().view(torch.int32)
    _, inv = torch.unique(torch.cat([pool, rows]), dim=0, return_inverse=True)
    return int((~torch.isin(inv[pool.shape[0]:], inv[:pool.shape[0]])).sum())
