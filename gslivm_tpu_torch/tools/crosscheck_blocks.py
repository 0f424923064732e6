"""Cross-check of the tile kernels across supertile block shapes (port of
tools/crosscheck_blocks.py): the renders and the gradients of one scene at
block (bx, by) must agree with block (2, 2), the default, before a shape
from exp_block's sweep is adopted.

The bench scene (exp_block.bench_scene) at (2, 2) with 914,048 instances
and at (bx, by) with 2^20, both with slack 0.3 and 32 chunks a tile: color,
depth and acc within max |diff| < 5e-4, and the gradients of the five
inputs of sum((C - 0)^2) + 0.1 sum(A) (depth_grad=False) within a relative
max diff < 2e-3 (of the (2, 2) gradient's max). Both renders' overflow is
printed. On the card the tiles run K1 and K2; on CPU tensors their plain
versions.

    python -m gslivm_tpu_torch.tools.crosscheck_blocks [bx by]   # default 2 4
"""

from __future__ import annotations

import sys

import torch

from ..ops.rasterize_tiles import rasterize_tiles
from .exp_block import HEIGHT, N, WIDTH, bench_scene

REF_BLOCK = (2, 2)
REF_INSTANCES = 914_048
ALT_INSTANCES = 1 << 20
SLACK = 0.3
CHUNKS = 32
IMAGE_TOL = 5e-4
GRAD_TOL = 2e-3
GRAD_NAMES = ("means", "scales", "quats", "opac", "shs")


def render(args, cam, block, maxi: int, depth_grad: bool = True):
    return rasterize_tiles(*args, cam, max_instances=maxi, capacity_slack=SLACK,
                           block_x=block[0], block_y=block[1], max_chunks_per_tile=CHUNKS,
                           depth_grad=depth_grad)


def grads(args, cam, block, maxi: int):
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = render(leaves, cam, block, maxi, depth_grad=False)
    loss = (out.color ** 2).sum() + 0.1 * out.acc.sum()
    return torch.autograd.grad(loss, leaves)


def _gate(bx: int, by: int, name: str, d: float, tol: float):
    if not d < tol:
        raise AssertionError(f"block ({bx},{by}) disagrees with (2,2) in {name}: "
                             f"{d:.3e} >= {tol}")


def crosscheck(bx: int, by: int, args, cam, ref_instances: int = REF_INSTANCES,
               alt_instances: int = ALT_INSTANCES, log=print) -> dict:
    """(bx, by) against (2, 2) on the scene `args`, `cam`: both overflows,
    the images' max |diff| and the gradients' relative max diffs. Raises
    AssertionError at the first value past its gate, the images first."""
    with torch.no_grad():
        ref = render(args, cam, REF_BLOCK, ref_instances)
        alt = render(args, cam, (bx, by), alt_instances)
    res = {"block": [bx, by], "overflow": [int(ref.overflow), int(alt.overflow)],
           "image_max_abs_diff": {}, "grad_rel_max_diff": {}}
    log(f"overflow: {res['overflow'][0]} {res['overflow'][1]}")
    for name in ("color", "depth", "acc"):
        d = float((getattr(ref, name) - getattr(alt, name)).abs().max())
        res["image_max_abs_diff"][name] = d
        log(f"{name}: max|diff| = {d:.3e}")
        _gate(bx, by, name, d, IMAGE_TOL)
    g_ref = grads(args, cam, REF_BLOCK, ref_instances)
    g_alt = grads(args, cam, (bx, by), alt_instances)
    for nm, a, b in zip(GRAD_NAMES, g_ref, g_alt):
        d = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-8)
        res["grad_rel_max_diff"][nm] = d
        log(f"grad {nm}: rel max diff = {d:.3e}")
        _gate(bx, by, f"grad {nm}", d, GRAD_TOL)
    log(f"cross-check OK: ({bx},{by}) matches (2,2) on {args[0].device}")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    bx, by = (int(argv[0]), int(argv[1])) if len(argv) > 1 else (2, 4)
    args, cam = bench_scene(N, WIDTH, HEIGHT, device="cuda")
    return crosscheck(bx, by, args, cam)


if __name__ == "__main__":
    main()
