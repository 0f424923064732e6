"""Pixel-axis scaling projection from one card (port of
tools/band_projection.py).

Pixel-band sharding lets one card stand for N: each rank of an N-way
"pixel" axis runs exactly the band-restricted render `rasterize_tiles(...,
band_rows=ceil(sgrid_y / N), band_start=...)` that this tool times here.
The projected step at N ranks is that band's measured fwd+bwd plus the
collectives' cost, computed from exact byte counts over a link rate, since
the collectives cannot run on one card:

  - the image all_gather over "pixel": each rank receives N-1 bands of 5
    f32 rows (C3, D, A);
  - the per-gaussian gradients summed over "pixel" (a ring all_reduce of
    10 f32 rows per gaussian moves 2 (N-1)/N of them); the band gradients
    themselves need no reduction (disjoint pixels).

The link rate is an ASSUMPTION, not a measurement, printed under its own
key `link_gbps_assumed`: 450 GB/s, an H100 SXM's NVLink 4 rate per
direction (18 links x 25 GB/s; NVIDIA's 900 GB/s is both directions). A
ring all_gather reaches less; no multi-card run exists to measure it. It
stands where the JAX tool's ICI_GBPS (a TPU v5e link estimate) stood, as a
module constant. The band is the central one, the densest. Run on the card:

    python -m gslivm_tpu_torch.tools.band_projection

Prints one JSON row per N with the measured band time (CUDA events; the
device busy time of its kernels beside it) and the projected step and FPS.
"""

from __future__ import annotations

import json

import torch

from ..ops.rasterize_reference import tile_grid
from ..ops.rasterize_tiles import rasterize_tiles
from .exp_block import bench_scene
from .timing import cuda_device, device_busy_ms, device_time_ms

WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 200_000
BLOCK = (2, 2)
MAXCH = 16
SLACK = 0.35
NVLINK_GBPS = 450.0
DEVICES = (1, 2, 4, 8, 16)


def band_geometry(n: int, width: int = WIDTH, height: int = HEIGHT, block=BLOCK) -> dict:
    """The central band of an n-way pixel axis in supertile rows, and its
    instance budget (the band's share of 900,000, + 40%, at least 2^17)."""
    sgrid_y = -(-tile_grid(width, height)[1] // block[1])
    band_rows = -(-sgrid_y // n)
    return {"band_rows": band_rows, "band_start": (sgrid_y - band_rows) // 2,
            "max_instances": max(1 << 17, int(900_000 // n * 1.4 // 128) * 128)}


def collective_bytes(n: int, band_rows: int, width: int = WIDTH, block=BLOCK,
                     n_gauss: int = N_GAUSS) -> dict:
    """Bytes a rank moves a step at n pixel ranks (f32): the image
    all_gather (n-1 bands of 5 rows) and the per-gaussian gradient all_reduce
    (2 (n-1)/n of 10 rows per gaussian)."""
    band_px = band_rows * 16 * block[1] * width
    return {"img_bytes": 5 * band_px * (n - 1) * 4,
            "grad_bytes": 2 * 10 * n_gauss * 4 * (n - 1) / max(n, 1)}


def band_loss_grad(cam, geo: dict):
    def fn(*args):
        leaves = [a.detach().requires_grad_(True) for a in args]
        out = rasterize_tiles(*leaves, cam, max_instances=geo["max_instances"],
                              capacity_slack=SLACK, block_x=BLOCK[0], block_y=BLOCK[1],
                              max_chunks_per_tile=MAXCH, band_rows=geo["band_rows"],
                              band_start=geo["band_start"])
        return torch.autograd.grad(out.color.sum() + 0.1 * out.acc.sum(), leaves)
    return fn


def run(device="cuda", devices=DEVICES, reps: int = 20, log=print) -> list[dict]:
    dev = cuda_device(device)
    args, cam = bench_scene(N_GAUSS, WIDTH, HEIGHT, device=dev)
    rows, base_ms = [], None
    for n in devices:
        geo = band_geometry(n)
        fn = band_loss_grad(cam, geo)
        with torch.no_grad():
            overflow = int(rasterize_tiles(
                *args, cam, max_instances=geo["max_instances"], capacity_slack=SLACK,
                block_x=BLOCK[0], block_y=BLOCK[1], max_chunks_per_tile=MAXCH,
                band_rows=geo["band_rows"], band_start=geo["band_start"]).overflow)
        ms = device_time_ms(fn, *args, reps=reps, device=dev)
        busy = device_busy_ms(fn, *args, reps=3, device=dev)["device_busy_ms"]
        base_ms = ms if base_ms is None else base_ms
        nbytes = collective_bytes(n, geo["band_rows"])
        comm_ms = (nbytes["img_bytes"] + nbytes["grad_bytes"]) / (NVLINK_GBPS * 1e9) * 1e3
        step_ms = ms + comm_ms
        row = {"pixel_devices": n, "band_rows": geo["band_rows"],
               "band_ms_measured": ms, "band_busy_ms_measured": busy,
               "comm_ms_modeled": comm_ms, "step_ms_projected": step_ms,
               "fps_projected": 1e3 / step_ms, "speedup_vs_1": base_ms / step_ms,
               "max_instances": geo["max_instances"], "overflow": overflow, **nbytes,
               "link_gbps_assumed": NVLINK_GBPS,
               "device": torch.cuda.get_device_name(dev)}
        log(json.dumps(row))
        rows.append(row)
    return rows


def main():
    run()


if __name__ == "__main__":
    main()
