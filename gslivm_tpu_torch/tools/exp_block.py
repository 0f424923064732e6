"""Supertile block-shape sweep on the 1080p bench scene (port of
tools/exp_block.py).

The bench scene (200,000 gaussians from default_rng(0), one 1920x1080
camera). For each (block_x, block_y) in (2,2), (3,2), (2,3), (4,2), (2,4) it
prints the instance expansion, the instances kept and the busiest tile's
chunks (`bin_instances` with 2^21 instances, 64 chunks a tile, slack 0.6),
the budgets fitted to them as bench.py fits its own (max_instances: the
expansion + 8%, rounded up to 128; chunks: min(64, 2 x the busiest)), then
the fwd+bwd time of sum((C - 0)^2) + 0.1 sum(A) at those budgets by CUDA
events (`timing.report`) with the device busy time of its kernels beside
it. A shape that fails prints `FAILED: ...` and the sweep goes on.
Validate a shape with crosscheck_blocks before adopting it. Run on the
card:

    python -m gslivm_tpu_torch.tools.exp_block
"""

from __future__ import annotations

import traceback

import numpy as np
import torch

from ..models.cameras import make_camera
from ..ops.binning import bin_instances
from ..ops.rasterize_reference import preprocess
from ..ops.rasterize_tiles import rasterize_tiles
from ..utils.device import resolve_device
from .timing import cuda_device, device_busy_ms, report

WIDTH, HEIGHT = 1920, 1080
N = 200_000
BLOCKS = ((2, 2), (3, 2), (2, 3), (4, 2), (2, 4))
STATS_INSTANCES = 1 << 21
STATS_CHUNKS = 64
STATS_SLACK = 0.6


def bench_scene(n: int = N, width: int = WIDTH, height: int = HEIGHT, device="cuda"):
    """((means, scales, quats, opacities, shs) activated, float32, the
    camera): the JAX tools' bench scene drawn from default_rng(0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    means = rng.normal(0, 2.0, (n, 3)) + [0, 0, 6.0]
    scales = rng.uniform(0.01, 0.05, (n, 3))
    q = rng.normal(size=(n, 4))
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,))
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3))
    args = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (means, scales, quats, opac, shs))
    cam = make_camera(np.eye(3), np.zeros(3), width, height, fovx=1.2, fovy=0.8, device=dev)
    return args, cam


@torch.no_grad()
def block_stats(args, cam, bx: int, by: int, max_instances: int = STATS_INSTANCES,
                chunks: int = STATS_CHUNKS, slack: float = STATS_SLACK) -> dict:
    """Instance expansion, instances kept and the busiest tile's chunks of
    the scene binned at supertile (bx, by)."""
    pre = preprocess(*args, cam)
    b = bin_instances(pre, cam.width, cam.height, max_instances, chunks,
                      capacity_slack=slack, block_x=bx, block_y=by)
    return {"expansion": int(b.num_instances), "kept": int(b.cnt_allowed.sum()),
            "maxch": int(b.tile_nchunks.max())}


def fitted_budgets(expansion: int, maxch: int) -> tuple[int, int]:
    """(max_instances, max_chunks_per_tile) as bench.py fits them: the
    expansion + 8% rounded up to 128, and twice the busiest tile's chunks
    capped at 64."""
    return int(np.ceil(expansion * 1.08 / 128)) * 128, min(64, 2 * maxch)


def sweep_loss(args, cam, **kw):
    """sum((C - 0)^2) + 0.1 sum(A) of the tile render of the five
    parameters `args`, with the rasterize_tiles keywords kw."""
    out = rasterize_tiles(*args, cam, **kw)
    return (out.color ** 2).sum() + 0.1 * out.acc.sum()


def loss_grad(cam, **kw):
    """fn(means, scales, quats, opac, shs) -> the five gradients of
    sweep_loss, rendered with the rasterize_tiles keywords kw."""
    def fn(*args):
        leaves = [a.detach().requires_grad_(True) for a in args]
        return torch.autograd.grad(sweep_loss(leaves, cam, **kw), leaves)
    return fn


def sweep(device="cuda", reps: int = 20, log=print) -> list[dict]:
    """One row per block shape: its stats, fitted budgets, the overflow at
    them, fwd+bwd ms by CUDA events and device busy ms, or `failed`."""
    dev = cuda_device(device)
    args, cam = bench_scene(device=dev)
    rows = []
    for bx, by in BLOCKS:
        st = block_stats(args, cam, bx, by)
        maxi, mc = fitted_budgets(st["expansion"], st["maxch"])
        log(f"block=({bx},{by}) expansion={st['expansion']} kept={st['kept']} "
            f"maxch={st['maxch']} -> maxi={maxi} mc={mc}")
        row = {"block": [bx, by], **st, "maxi": maxi, "mc": mc}
        try:
            with torch.no_grad():
                row["overflow"] = int(rasterize_tiles(
                    *args, cam, max_instances=maxi, block_x=bx, block_y=by,
                    max_chunks_per_tile=mc).overflow)
            fn = loss_grad(cam, max_instances=maxi, block_x=bx, block_y=by,
                           max_chunks_per_tile=mc)
            row["ms"] = report(f"fwd+bwd ({bx},{by})", fn, *args, reps=reps, device=dev)
            row["busy_ms"] = device_busy_ms(fn, *args, reps=3, device=dev)["device_busy_ms"]
        except Exception as e:  # the sweep reports a failing shape and goes on
            row["failed"] = f"{type(e).__name__}: {e}"
            row["traceback"] = traceback.format_exc()
            log(f"  FAILED: {row['failed']}")
        rows.append(row)
    return rows


def main():
    sweep()


if __name__ == "__main__":
    main()
