"""Tile binning: per-gaussian tile rects -> depth-sorted per-tile instance runs
(port of gslivm_tpu/ops/binning.py, sorted layout only).

Replaces the reference's dynamic binning (`rasterizer_impl.cu`: cub
InclusiveSum 270-273, duplicateWithKeys 64-101, radix SortPairs 295-309,
identifyTileRanges 106-125) with a STATIC instance budget, so no host sync
is needed mid-pipeline:

  1. Gaussians are depth-ranked first (stable; invalid last). Instance ids
     then live in rank space and rank order == (depth, index) order.
  2. Each instance slot finds its gaussian by a searchsorted over the run
     offsets, and its tile by integer division within the gaussian's rect,
     row-major like duplicateWithKeys.
  3. Optional per-(gaussian, tile) ELLIPSE CULL (tile_cull=True) drops
     instances whose tile lies wholly outside the alpha >= 1/255 level set.
     Lossless for images and gradients.
  4. ONE sort of the int64 key (tile << 32) | rank. (tile, rank) pairs are
     unique, so it reproduces both the JAX package's packed-int32 sort and
     its two-key sort, sentinel slots included.
  5. Per-tile runs are capped at max_chunks_per_tile * CHUNK and clipped to
     the CHUNK-padded capacity; what is dropped is counted in `overflow`.

A band (band_start, band_rows) bins only those tile rows, the unit of the
pixel axis of the sharded step (parallel/sharding.py): rects are clipped to
the band and tile ids come out band-relative.

Integer outputs are bit-equal to the JAX package's (`tests/test_torch_rasterize.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rasterize_reference import (
    TILE,
    TILE_CULL_EPS,
    PreprocessedGaussians,
    tile_grid,
    tile_min_power,
)

CHUNK = 128  # render-kernel chunk size: the early-stop vote and neff count in it


class BinnedInstances(NamedTuple):
    dorder: torch.Tensor        # [num_gauss] int32 rank -> original gaussian id
    tile_nchunks: torch.Tensor  # [num_tiles] int32 — chunks of CHUNK instances
    tile_offset: torch.Tensor   # [num_tiles] int32 — start slot in the
                                #   CHUNK-padded layout
    num_instances: torch.Tensor # [] int32 — real (unpadded, unclamped) count
    overflow: torch.Tensor      # [] int32 — instances dropped by the budgets
    gid_sorted: torch.Tensor    # [max_instances] int32 rank id per SORTED slot
                                #   (tile-major, depth order within a tile)
    sorted_start: torch.Tensor  # [num_tiles] int32 — tile run start in the
                                #   sorted layout
    cnt_allowed: torch.Tensor   # [num_tiles] int32 — kept instances per tile


def bin_instances(
    pre: PreprocessedGaussians,
    width: int,
    height: int,
    max_instances: int,
    max_chunks_per_tile: int = 64,
    tile_cull: bool = True,
    capacity_slack: float = 1.0,
    block_x: int = 1,
    block_y: int = 1,
    band_start: int | None = None,
    band_rows: int | None = None,
) -> BinnedInstances:
    """Expand gaussians into depth-sorted per-tile instance runs.

    max_instances bounds the pre-sort expansion; max_chunks_per_tile bounds
    each tile's run (the nearest instances survive). The CHUNK-padded
    capacity is `max_instances + capacity_slack * num_tiles * (CHUNK - 1)`
    rounded up; a too-small budget becomes counted overflow, never
    out-of-bounds access.

    block_x/block_y bin at SUPERTILE granularity: one bin covers a
    (block_x*16) x (block_y*16) pixel block (one render-kernel block), and
    returned tile ids are supertile ids.

    band_start/band_rows (both given, or neither) restrict binning to
    supertile rows [band_start, band_start + band_rows): rects are clipped
    to the band, tile ids are band-relative and there are sgrid_x *
    band_rows tiles. A band past the image bins nothing.
    """
    grid_x, grid_y = tile_grid(width, height)
    blocked = block_x != 1 or block_y != 1
    sgrid_x = -(-grid_x // block_x)
    sgrid_y = -(-grid_y // block_y)
    banded = band_rows is not None
    if banded != (band_start is not None):
        raise ValueError("band_start and band_rows go together")
    y0 = int(band_start) if banded else 0
    num_tiles = sgrid_x * (band_rows if banded else sgrid_y)
    dev = pre.depth.device

    depth = pre.depth.detach()
    dorder = torch.argsort(
        torch.where(pre.valid, depth, torch.full_like(depth, float("inf"))),
        stable=True)

    rect_min = pre.rect_min[dorder].long()
    rect_max = pre.rect_max[dorder].long()
    rmin_x, rmin_y = rect_min[:, 0], rect_min[:, 1]
    rmax_x, rmax_y = rect_max[:, 0], rect_max[:, 1]
    validg = pre.valid[dorder]
    if blocked:
        # exact supertile cover of the tile range [rect_min, rect_max);
        # empty rects stay empty
        empty = (rmax_x <= rmin_x) | (rmax_y <= rmin_y)
        rmin_x = rmin_x // block_x
        rmin_y = rmin_y // block_y
        rmax_x = torch.where(empty, rmin_x, -((-rmax_x) // block_x))
        rmax_y = torch.where(empty, rmin_y, -((-rmax_y) // block_y))
    if banded:
        # clip to the band, band-relative rows
        rmin_y = torch.clamp(rmin_y, y0, y0 + band_rows) - y0
        rmax_y = torch.clamp(rmax_y, y0, y0 + band_rows) - y0
    counts = torch.where(validg, (rmax_x - rmin_x) * (rmax_y - rmin_y),
                         torch.zeros_like(rmax_x))
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()

    # slot -> (rank-space) gaussian: the largest rank whose run starts at or
    # before the slot (zero-count gaussians share their successor's start).
    # Slots run to max_instances rounded up to 128, as in the JAX package,
    # so that its sentinel slots are reproduced exactly.
    mi2 = -(-max_instances // 128) * 128
    slots = torch.arange(mi2, device=dev)
    gid = torch.searchsorted(offsets, slots, right=True) - 1
    slot_valid = slots < torch.clamp(total, max=max_instances)

    # slot -> tile within the gaussian's rect, row-major (duplicateWithKeys)
    rect_w = torch.clamp(rmax_x - rmin_x, min=1)[gid]
    k = slots - offsets[gid]
    q = k // rect_w
    tx = rmin_x[gid] + (k - q * rect_w)
    ty = rmin_y[gid] + q
    tile_id = ty * sgrid_x + tx

    sentinel = torch.full_like(tile_id, num_tiles)
    if tile_cull:
        mean2d = pre.mean2d.detach()
        conic = pre.conic.detach()
        op = torch.where(pre.valid, pre.opacity.detach(),
                         torch.zeros_like(pre.depth))
        ca, cb, cc = conic[:, 0], conic[:, 1], conic[:, 2]
        # log-domain keep threshold: q_min <= log(op / EPS) <=> op *
        # exp(-q_min) >= EPS; +1e-6 keeps the boundary conservative
        lq = torch.where(
            op > 0.0,
            torch.log(torch.clamp(op, min=1e-30) / TILE_CULL_EPS) + 1e-6,
            torch.full_like(op, -float("inf")))
        g = dorder[gid]
        qmin = tile_min_power(mean2d[g, 0], mean2d[g, 1], ca[g], cb[g], cc[g],
                              tx, ty + y0, pw=TILE * block_x, ph=TILE * block_y,
                              rb_a=(-cb / torch.clamp(ca, min=1e-12))[g],
                              rb_c=(-cb / torch.clamp(cc, min=1e-12))[g])
        tile_id = torch.where(qmin <= lq[g], tile_id, sentinel)
    tile_id = torch.where(slot_valid, tile_id, sentinel)

    key_sorted = torch.sort((tile_id << 32) | gid).values[:max_instances]
    tile_sorted = key_sorted >> 32
    gid_sorted = key_sorted & 0xFFFFFFFF

    # per-tile ranges (identifyTileRanges) + cap + CHUNK padding
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, device=dev))
    start = bounds[:-1]
    cnt = bounds[1:] - start
    cnt_capped = torch.clamp(cnt, max=CHUNK * max_chunks_per_tile)
    cnt_padded = (cnt_capped + CHUNK - 1) // CHUNK * CHUNK
    tile_offset = torch.cumsum(cnt_padded, 0) - cnt_padded

    # clip per-tile budgets to the static padded capacity
    padded_size = _padded_capacity(max_instances, num_tiles, capacity_slack)
    avail = torch.minimum(torch.clamp(padded_size - tile_offset, min=0),
                          cnt_padded)
    cnt_allowed = torch.minimum(cnt_capped, avail)
    overflow = torch.clamp(total - max_instances, min=0) + (cnt - cnt_allowed).sum()

    i32 = torch.int32
    return BinnedInstances(
        dorder=dorder.to(i32),
        tile_nchunks=((cnt_allowed + CHUNK - 1) // CHUNK).to(i32),
        tile_offset=tile_offset.to(i32),
        num_instances=total.to(i32),
        overflow=overflow.to(i32),
        gid_sorted=gid_sorted.to(i32),
        sorted_start=start.to(i32),
        cnt_allowed=cnt_allowed.to(i32),
    )


def _padded_capacity(max_instances: int, num_tiles: int,
                     slack: float = 1.0) -> int:
    """Static CHUNK-padded capacity: the worst-case alignment padding scaled
    by `slack`, rounded up to a CHUNK multiple."""
    worst = max_instances + num_tiles * (CHUNK - 1)
    cap = min(max_instances + int(slack * num_tiles * (CHUNK - 1)), worst)
    return ((cap + CHUNK - 1) // CHUNK) * CHUNK
