"""The image loss at 1080p, forward and backward (port of
tools/microbench_losses.py).

Two seeded uniform 3x1080x1920 images (default_rng(0)). The default mode
times, through the port's `ops/losses.py` (whose SSIM blurs are one K3
launch, `_blur_parts`):

  ssim fwd, ssim fwd+bwd, l1 fwd+bwd, image_loss fwd+bwd, psnr fwd

and, as the library's yardstick, the separable SSIM written with two
depthwise `F.conv2d` passes a blur (`ssim separable fwd+bwd`). cuDNN's
TF32 is switched off while the tool runs, so every convolution sums in
full float32, as K3 does. `stack` times the stacked five-part SSIM (one
K3 launch forward, one backward) against five separate blur chains (five
launches forward, three backward).

Each row: ms by CUDA events, device busy ms and kernels per call, and the
busy ms split into K3 and the rest (the SSIM algebra's elementwise
kernels, `other_ms`) by `timing.profile_cuts`. Run on the card (--cpu is
refused):

    python -m gslivm_tpu_torch.tools.microbench_losses [stack] [--reps 20]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import losses
from ..ops.blur import blur_many
from ..utils.device import device_name
from .timing import cuda_device, profile_cuts

W, H = 1920, 1080


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="main", choices=("main", "stack"))
    ap.add_argument("--reps", type=int, default=20, help="calls a row is timed over")
    ap.add_argument("--cpu", action="store_true")
    return ap


def images(h: int = H, w: int = W, device="cuda"):
    """(a, b): the tool's two uniform [3, h, w] float32 images."""
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, h, w))
    b = rng.uniform(size=(3, h, w))
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device) for x in (a, b))


def ssim_loss(x, b):
    return 1.0 - losses.ssim(x, b)


def grad_of(loss):
    """fn(x, b) -> d loss(x, b) / dx."""
    def fn(x, b):
        leaf = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss(leaf, b), leaf)[0]
    fn.__name__ = f"grad_{loss.__name__}"
    return fn


def conv_sep(img, taps: np.ndarray):
    """The zero-padded SAME separable blur of [C, H, W] as two depthwise
    F.conv2d passes (a correlation, as K3)."""
    c, k = img.shape[0], len(taps)
    t = torch.as_tensor(taps, dtype=img.dtype, device=img.device)
    out = F.conv2d(img[None], t.reshape(1, 1, 1, k).expand(c, 1, 1, k),
                   padding=(0, k // 2), groups=c)
    return F.conv2d(out, t.reshape(1, 1, k, 1).expand(c, 1, k, 1),
                    padding=(k // 2, 0), groups=c)[0]


def _ssim_from(mu1, mu2, m11, m22, m12):
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    m = ((2.0 * mu1_mu2 + losses._C1) * (2.0 * (m12 - mu1_mu2) + losses._C2)) / (
        (mu1_sq + mu2_sq + losses._C1) * ((m11 - mu1_sq) + (m22 - mu2_sq) + losses._C2))
    return 1.0 - m.mean()


def ssim_conv2d(x, b):
    """1 - SSIM with every blur a depthwise F.conv2d pair: the yardstick."""
    taps = losses.gaussian_1d()
    return _ssim_from(*(conv_sep(p, taps) for p in (x, b, x * x, b * b, x * b)))


def ssim_stack(x, b):
    """The [15, H, W] stack that `losses.ssim` blurs in one K3 launch."""
    return torch.cat([x, b, x * x, b * b, x * b], dim=0)


def ssim_separate(x, b):
    """1 - SSIM with five separate blur chains: one blur_many launch a part."""
    taps = losses.gaussian_1d()
    return _ssim_from(*(blur_many(p, taps) for p in (x, b, x * x, b * b, x * b)))


MAIN_ROWS = (("ssim fwd", ssim_loss), ("ssim fwd+bwd", grad_of(ssim_loss)),
             ("l1 fwd+bwd", grad_of(losses.l1_loss)),
             ("image_loss fwd+bwd", grad_of(losses.image_loss)), ("psnr fwd", losses.psnr),
             ("ssim separable fwd+bwd", grad_of(ssim_conv2d)))
STACK_ROWS = (("ssim STACKED fwd+bwd", grad_of(ssim_loss)),
              ("ssim separate fwd+bwd", grad_of(ssim_separate)))


def run(args, device="cuda", log=print) -> dict:
    """The rows of args.mode timed by timing.profile_cuts (TF32 off in
    cuDNN meanwhile); in the default mode also the SSIM of the K3 path and
    of the F.conv2d path, as the JAX tool prints them."""
    dev = cuda_device(device)
    a, b = images(device=dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {"device": device_name(dev), "mode": args.mode, "shape": [3, H, W],
               "cudnn_allow_tf32": False, "reps": args.reps}
        if args.mode == "main":
            v1, v2 = float(ssim_loss(a, b)), float(ssim_conv2d(a, b))
            log(f"ssim 2d={v1:.6f} separable={v2:.6f} diff={abs(v1 - v2):.2e}")
            res["ssim_loss"] = {"k3": v1, "conv2d": v2}
        rows = MAIN_ROWS if args.mode == "main" else STACK_ROWS
        res["rows"] = profile_cuts([(name, fn, (a, b)) for name, fn in rows],
                                   reps=args.reps, device=dev, log=log, cumulative=False)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return res


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
