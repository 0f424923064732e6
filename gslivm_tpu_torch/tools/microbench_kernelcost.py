"""Fixed-versus-variable cost split of the tile kernels (counterpart of
tools/microbench_kernelcost.py; no kernel of its own).

Drives K1, K2, and the differentiable tile render (gather + K1 with
checkpoints, then K2, which sums the gradient per gaussian, and the
gradient's permutation back; the `fwd_bwd_scatter` fields keep their name;
timed by CUDA events and, as `_busy_ms`, by the device time of its
kernels) through
`rasterize_tiles.render_from_table` on FABRICATED runs: the JAX tool's case
of 200,000 gaussians on 60 x 34 supertiles of 32 x 32 pixels, uniform chunk
counts per tile, the rect test on, opacities too small ever to stop a
pixel, so every tile walks all its chunks. It sweeps the chunks per tile
over 1, 2, 4 and 8 and asserts in every tile at every point that the walk
covered them all (neff == nch). The two-point slope of ms against total
chunks (nch 1 and 8) is the per-chunk cost; the intercept over tiles is the
per-tile overhead. Loss for the backward: sum(tiles[:, :5]^2). Run on the
card:

    python -m gslivm_tpu_torch.tools.microbench_kernelcost
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rasterize_tiles as rt
from ..ops.binning import CHUNK, BinnedInstances
from ..utils.device import resolve_device
from .timing import device_busy_ms, device_time_ms

GX, GY = 60, 34     # the bench's supertile grid (2x2 blocks at 1080p)
P = 200_000
SWEEP = (1, 2, 4, 8)
MAX_CHUNKS = 8


def fabricated_case(nch: int, device="cuda", grid=(GX, GY), num_gaussians: int = P):
    """(rank table [16, P], binned, cfg) of the JAX tool's run_case(nch),
    drawn from default_rng(0) in its order."""
    dev = resolve_device(device)
    gx, gy = grid
    n = num_gaussians
    num_tiles = gx * gy
    total = num_tiles * nch * CHUNK
    rng = np.random.default_rng(0)
    table = np.zeros((rt.FEAT, n), np.float32)
    table[rt._FX] = rng.uniform(0, gx * 32, n)
    table[rt._FY] = rng.uniform(0, gy * 32, n)
    table[rt._FA] = 2e-4   # a huge splat: covers every pixel weakly
    table[rt._FC] = 2e-4
    table[rt._FO] = 0.02
    table[rt._FR] = rng.uniform(0, 1, n)
    table[rt._FG] = rng.uniform(0, 1, n)
    table[rt._FB2] = rng.uniform(0, 1, n)
    table[rt._FD] = rng.uniform(1, 5, n)
    table[rt._FX0] = -1e9
    table[rt._FX1] = 1e9
    table[rt._FY0] = -1e9
    table[rt._FY1] = 1e9
    table[rt._FID] = np.arange(n, dtype=np.float32)
    gid = rng.integers(0, n, total + 2 * CHUNK).astype(np.int32)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    start = i32(np.arange(num_tiles) * nch * CHUNK)
    binned = BinnedInstances(
        dorder=i32(np.arange(n)), tile_nchunks=i32(np.full(num_tiles, nch)),
        tile_offset=start, num_instances=i32(total), overflow=i32(0),
        gid_sorted=i32(gid), sorted_start=start,
        cnt_allowed=i32(np.full(num_tiles, nch * CHUNK)))
    cfg = rt.TileConfig(grid_x=gx, grid_y=gy, pw=32, ph=32, rect_test=True,
                        contrib_stats=False, max_chunks=MAX_CHUNKS)
    return torch.as_tensor(table, device=dev), binned, cfg


def check_full_walk(tiles, nch: int):
    """Raise unless every tile walked all nch chunks (neff == nch)."""
    neff = tiles[:, 7, 0]
    short = int((neff != nch).sum())
    if short:
        raise AssertionError(f"{short} of {neff.numel()} tiles stopped before "
                             f"their {nch} chunks: the slope would not be per chunk")


def loss_of(tiles):
    return (tiles[:, :5] ** 2).sum()


def run_case(nch: int, device="cuda", reps: int = 10) -> dict:
    """ms of K1, K2, the forward render and forward + backward."""
    table, binned, cfg = fabricated_case(nch, device)
    args = (binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed)
    with torch.no_grad():
        inst = table.t()[binned.gid_sorted.long()].contiguous()
        tiles, ckpt = rt.composite_tiles(inst, *args, cfg, save_ckpt=True)
        check_full_walk(tiles, nch)
        g_tiles = torch.zeros_like(tiles)
        g_tiles[:, :5] = 2.0 * tiles[:, :5]  # d loss_of / d tiles
        k1 = device_time_ms(lambda: rt.composite_tiles(inst, *args, cfg), reps=reps,
                            device=device)
        k2 = device_time_ms(lambda: rt.composite_tiles_bwd(
            inst, binned.sorted_start, binned.cnt_allowed, g_tiles, tiles, ckpt, cfg,
            table.shape[1], depth_grad=False), reps=reps, device=device)
        fwd = device_time_ms(lambda: rt.render_from_table(table, binned, cfg, False),
                             reps=reps, device=device)
    leaf = table.clone().requires_grad_(True)

    def both():
        return torch.autograd.grad(loss_of(rt.render_from_table(leaf, binned, cfg, False)),
                                   leaf)

    fwd_bwd = device_time_ms(both, reps=reps, device=device)
    busy = device_busy_ms(both, reps=3, device=device)
    return {"nch": nch, "chunks": cfg.num_tiles * nch, "k1_ms": k1, "k2_ms": k2,
            "fwd_ms": fwd, "fwd_bwd_scatter_ms": fwd_bwd,
            "fwd_bwd_scatter_busy_ms": busy["device_busy_ms"],
            "fwd_bwd_scatter_kernels": busy["kernels_per_call"],
            "k1_us_per_chunk": k1 * 1e3 / (cfg.num_tiles * nch)}


def split(rows: list[dict], key: str, tiles: int = GX * GY) -> dict:
    """Two-point slope (us per chunk) and per-tile intercept (us) of
    rows[key] against total chunks, from the first and last sweep points."""
    a, b = rows[0], rows[-1]
    slope = (b[key] - a[key]) / (b["chunks"] - a["chunks"]) * 1e3
    return {"slope_us_per_chunk": slope,
            "per_tile_us": (a[key] * 1e3 - slope * a["chunks"]) / tiles}


def sweep(device="cuda", reps: int = 10) -> dict:
    rows = [run_case(n, device, reps) for n in SWEEP]
    return {"rows": rows,
            "fits": {k: split(rows, k) for k in ("k1_ms", "k2_ms", "fwd_ms",
                                                 "fwd_bwd_scatter_ms",
                                                 "fwd_bwd_scatter_busy_ms")}}


def main():
    res = sweep()
    for r in res["rows"]:
        print(f"nch={r['nch']}: K1 {r['k1_ms']:7.3f} ms ({r['k1_us_per_chunk']:.4f} us/chunk)"
              f"  K2 {r['k2_ms']:7.3f} ms  fwd {r['fwd_ms']:7.3f} ms"
              f"  fwd+bwd+scatter {r['fwd_bwd_scatter_ms']:7.3f} ms", flush=True)
    for k, f in res["fits"].items():
        print(f"{k}: slope {f['slope_us_per_chunk']:.4f} us/chunk, per-tile overhead "
              f"{f['per_tile_us']:.4f} us", flush=True)


if __name__ == "__main__":
    main()
