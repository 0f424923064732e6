"""Bilinear sampling at 1080p, the delta-depth warp's hot op (port of
tools/microbench_gridsample.py).

A seeded uniform 1080x1920 image and one sample point a pixel, drawn as
the JAX tool draws them (default_rng(0): x in [-2, W + 1), y in [-2, H +
1), so some footprints lie partly or wholly outside the image, which
samples zero there). The point is handed to the port's warp in its
normalised form, and every variant samples at the pixel coordinates the
warp recovers from it, (g + 1) / 2 * (size - 1) in float32, so all four
see the same points. Four variants, each forward and forward + backward
in the image:

  warp              the port's warp, `training._grid_sample_2d`
                    (F.grid_sample, align_corners=True, zero padding)
  4 separate taps   the JAX tool's `taps4`: four 2-D gathers, masked
  4 FLAT taps       four gathers from the flattened image
  [2,2]-window      one gather of each point's 2x2 window from the image
  gather            padded by 2

They must agree (1e-6 of scale, asserted before timing). Each row: ms by
CUDA events, device busy ms and kernels per call (`timing.profile_cuts`).
Run on the card (--cpu is refused):

    python -m gslivm_tpu_torch.tools.microbench_gridsample [--reps 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..models.training import _grid_sample_2d
from ..utils.device import device_name
from .timing import cuda_device, profile_cuts

H, W = 1080, 1920
TOL = 1e-6


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="calls a row is timed over")
    ap.add_argument("--cpu", action="store_true")
    return ap


def make_inputs(h: int = H, w: int = W, device="cuda"):
    """(img, x, y, gx, gy): the image, the pixel coordinates every variant
    samples at and the normalised coordinates the warp takes for them."""
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(h, w))
    x = rng.uniform(-2, w + 1, (h, w))
    y = rng.uniform(-2, h + 1, (h, w))
    img, x, y = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in (img, x, y))
    gx, gy = x / (w - 1) * 2.0 - 1.0, y / (h - 1) * 2.0 - 1.0
    return img, (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1), gx, gy


def warp(img, gx, gy):
    return _grid_sample_2d(img, gx, gy)


def _bilinear(taps, x, y):
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    v00, v01, v10, v11 = (taps(y0 + dy, x0 + dx) for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _inside(img, yy, xx):
    h, w = img.shape
    return (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)


def _clipped(img, yy, xx):
    h, w = img.shape
    return yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()


def taps4(img, x, y):
    def tap(yy, xx):
        yi, xi = _clipped(img, yy, xx)
        return torch.where(_inside(img, yy, xx), img[yi, xi], 0.0)
    return _bilinear(tap, x, y)


def taps4_flat(img, x, y):
    flat = img.reshape(-1)

    def tap(yy, xx):
        yi, xi = _clipped(img, yy, xx)
        return torch.where(_inside(img, yy, xx), flat[yi * img.shape[1] + xi], 0.0)
    return _bilinear(tap, x, y)


def window2x2(img, x, y):
    """Each point's 2x2 window, gathered at once from the image padded by 2
    (zeros outside it)."""
    h, w = img.shape
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    imgp = F.pad(img, (2, 2, 2, 2))
    y0 = (y0f.clamp(-2, h) + 2).long()[..., None, None]
    x0 = (x0f.clamp(-2, w) + 2).long()[..., None, None]
    d = torch.arange(2, device=img.device)
    win = imgp[y0 + d[:, None], x0 + d[None, :]]  # [h, w, 2, 2]
    return (win[..., 0, 0] * (1 - wx) * (1 - wy) + win[..., 0, 1] * wx * (1 - wy)
            + win[..., 1, 0] * (1 - wx) * wy + win[..., 1, 1] * wx * wy)


def image_grad(fn):
    """fn'(img, u, v) -> d sum(fn(img, u, v)) / d img."""
    def g(img, u, v):
        leaf = img.detach().requires_grad_(True)
        return torch.autograd.grad(fn(leaf, u, v).sum(), leaf)[0]
    g.__name__ = f"grad_{fn.__name__}"
    return g


VARIANTS = (("warp", warp, "g"), ("4 separate taps", taps4, "xy"),
            ("4 FLAT taps", taps4_flat, "xy"), ("[2,2]-window gather", window2x2, "xy"))


def cuts(img, x, y, gx, gy):
    """(name, fn, args) of every variant's forward and forward + backward."""
    out = []
    for name, fn, coords in VARIANTS:
        args = (img, gx, gy) if coords == "g" else (img, x, y)
        out += [(f"{name} fwd", fn, args), (f"{name} fwd+bwd(img)", image_grad(fn), args)]
    return out


def max_scaled_diffs(img, x, y, gx, gy) -> dict:
    """max |variant - 4 separate taps| over max(|taps|, 1) of each row."""
    rows = {name: fn(*args) for name, fn, args in cuts(img, x, y, gx, gy)}
    out = {}
    for name, _, _ in VARIANTS:
        for kind in (" fwd", " fwd+bwd(img)"):
            ref = rows["4 separate taps" + kind]
            out[name + kind] = float((rows[name + kind] - ref).abs().max()
                                     / max(float(ref.abs().max()), 1.0))
    return out


def run(args, device="cuda", log=print) -> dict:
    """The variants held against each other, then timed by
    timing.profile_cuts."""
    dev = cuda_device(device)
    inputs = make_inputs(device=dev)
    diffs = max_scaled_diffs(*inputs)
    log(f"max scaled |variant - 4 separate taps|: {diffs}")
    assert max(diffs.values()) <= TOL, diffs
    rows = profile_cuts(cuts(*inputs), reps=args.reps, device=dev, log=log, cumulative=False)
    return {"device": device_name(dev), "shape": [H, W], "reps": args.reps,
            "max_scaled_diff": diffs, "tol": TOL, "rows": rows}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
