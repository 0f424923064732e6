"""Tile rasterizer, forward (port of the forward half of
gslivm_tpu/ops/rasterize_pallas.py).

Pipeline: preprocess -> bin_instances (supertile runs, depth-sorted) ->
the [16, P] rank-ordered feature table -> gather into the sorted instance
layout -> the tile compositor K1 (`csrc/tile_forward.cu`) -> image.

`composite_tiles` launches K1 on CUDA tensors and takes its plain PyTorch
version `composite_tiles_plain` only for CPU tensors. The plain version
repeats the TPU kernel's per-chunk math (`_chunk_terms`) vectorised over a
group of tiles, including its Hillis-Steele prefix product, so that it is
the closest CPU twin of the JAX kernel run in interpret mode.

This slice renders forward only: the backward tile kernel (K2) and the
forward's chunk-start checkpoints come with the training slice, and
`rasterize_tiles` raises when a gradient is asked of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .binning import CHUNK, BinnedInstances, bin_instances
from .rasterize_reference import (
    TILE,
    PreprocessedGaussians,
    RenderOutput,
    preprocess,
    tile_grid,
)

FEAT = 16  # packed instance feature columns (15 used)
# feature columns; _FX0.._FY1 are the splat's 16x16 TILE-rect bounds in
# pixels, used only in supertile mode (the per-pixel rect test)
(_FX, _FY, _FA, _FB, _FC, _FO, _FR, _FG, _FB2, _FD,
 _FX0, _FX1, _FY0, _FY1) = range(14)
_FID = 14  # the column's own rank id (exact f32), for the training slice's
           # gradient scatter
# the plain compositor steps as many tiles at once as keep one [tiles, CHUNK,
# npix] f32 array within this many elements (64 MB), so that a 1080p frame
# fits on the card
_PLAIN_GROUP_ELEMENTS = 1 << 24


class TileConfig(NamedTuple):
    """Static geometry of a tile render: grid_x * grid_y blocks of pw x ph
    pixels (pw = 16 * block_x, ph = 16 * block_y)."""

    grid_x: int
    grid_y: int
    pw: int = TILE
    ph: int = TILE
    rect_test: bool = False      # supertile mode: per-pixel tile-rect test
    contrib_stats: bool = True   # False renders n_contrib as zeros

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def npix(self) -> int:
        return self.pw * self.ph


def _build_rank_table(pre: PreprocessedGaussians, dorder, rect_rows: bool = False):
    """The [FEAT, P] per-gaussian screen-feature table in DEPTH-RANK column
    order. rect_rows appends the 4 tile-rect pixel bounds (supertile mode's
    rect test) as exact f32 values; row _FID is the column's rank id.
    Invalid gaussians enter with opacity 0."""
    rows = [
        pre.mean2d[:, 0],
        pre.mean2d[:, 1],
        pre.conic[:, 0],
        pre.conic[:, 1],
        pre.conic[:, 2],
        torch.where(pre.valid, pre.opacity, torch.zeros_like(pre.opacity)),
        pre.color[:, 0],
        pre.color[:, 1],
        pre.color[:, 2],
        pre.depth,
    ]
    if rect_rows:
        rows += [
            (pre.rect_min[:, 0] * TILE).to(torch.float32),
            (pre.rect_max[:, 0] * TILE).to(torch.float32),
            (pre.rect_min[:, 1] * TILE).to(torch.float32),
            (pre.rect_max[:, 1] * TILE).to(torch.float32),
        ]
    n = dorder.shape[0]
    table = torch.stack(rows, dim=0)[:, dorder.long()]
    zeros = table.new_zeros
    return torch.cat([
        table,
        zeros((_FID - len(rows), n)),
        torch.arange(n, dtype=table.dtype, device=table.device)[None, :],
        zeros((FEAT - _FID - 1, n)),
    ], dim=0)


def _cumprod_rows(x, exclusive: bool):
    """Prefix product along dim 1 of a [G, CHUNK, npix] array: the TPU
    kernel's multiplicative Hillis-Steele scan (ones-filled shifts)."""
    n = x.shape[1]
    s = 1
    while s < n:
        x = x * torch.cat([torch.ones_like(x[:, :s]), x[:, :n - s]], dim=1)
        s *= 2
    if exclusive:
        x = torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=1)
    return x


def _chunk_terms(feat, px, py, T_in, done_in, rect_test: bool):
    """One chunk of the TPU kernel's math (rasterize_pallas.py:_chunk_terms),
    for a group of tiles at once.

    feat: [G, CHUNK, FEAT]; px/py: [G, 1, npix]; T_in/done_in: [G, 1, npix].
    Returns (w [G, CHUNK, npix], contrib, T_out [G, 1, npix], done_out).
    """
    def col(i):
        return feat[:, :, i, None]

    dx = col(_FX) - px
    dy = col(_FY) - py
    power = -0.5 * (col(_FA) * dx * dx + col(_FC) * dy * dy) - col(_FB) * dx * dy
    alpha = torch.clamp(col(_FO) * torch.exp(power), max=0.99)
    accepted = (power <= 0.0) & (alpha >= 1.0 / 255.0)
    if rect_test:
        accepted = (accepted & (px >= col(_FX0)) & (px < col(_FX1))
                    & (py >= col(_FY0)) & (py < col(_FY1)))
    one = torch.ones_like(alpha)
    one_minus_eff = torch.where(accepted, 1.0 - alpha, one)

    T_prev = T_in * _cumprod_rows(one_minus_eff, exclusive=True)
    T_next = T_prev * (1.0 - alpha)
    would_stop = accepted & (T_next < 1e-4)
    # the early-stop latch needs no scan: once T_prev*(1-alpha) < 1e-4 fires,
    # every later accepted splat fails the same test (T_prev non-increasing)
    contrib = accepted & ~done_in & (T_next >= 1e-4)
    w = torch.where(contrib, alpha * T_prev, torch.zeros_like(alpha))
    T_out = torch.where(contrib, T_next, T_in.expand_as(T_next)).amin(dim=1, keepdim=True)
    done_out = done_in | would_stop.any(dim=1, keepdim=True)
    return w, contrib, T_out, done_out


def composite_tiles_plain(inst, sorted_start, tile_nchunks, cnt_allowed,
                          cfg: TileConfig):
    """The plain PyTorch version of K1: [L, FEAT] sorted instances ->
    [T, 8, npix] rows (C_r, C_g, C_b, D, A, T_final, n_contrib, neff).

    A loop over chunk index, vectorised over a group of tiles at a time."""
    dev = inst.device
    T_all, npix, pw = cfg.num_tiles, cfg.npix, cfg.pw
    group = max(1, _PLAIN_GROUP_ELEMENTS // (CHUNK * npix))
    out = torch.empty((T_all, 8, npix), dtype=torch.float32, device=dev)
    p = torch.arange(npix, device=dev)
    j = torch.arange(CHUNK, device=dev)
    for g0 in range(0, T_all, group):
        t = torch.arange(g0, min(g0 + group, T_all), device=dev)
        px = ((t % cfg.grid_x)[:, None] * pw + p % pw).to(torch.float32)[:, None]
        py = ((t // cfg.grid_x)[:, None] * cfg.ph + p // pw).to(torch.float32)[:, None]
        start = sorted_start[t].long()
        nch = tile_nchunks[t].long()
        cnt = cnt_allowed[t].long()
        zeros = torch.zeros_like(px)
        T = torch.ones_like(px)
        done = torch.zeros_like(px, dtype=torch.bool)
        C0, C1, C2, D, A, N = (zeros.clone() for _ in range(6))
        neff = torch.full_like(nch, -1)
        for i in range(int(nch.max()) if len(t) else 0):
            all_done = done.all(dim=2)[:, 0]
            has = i < nch
            neff = torch.where((neff < 0) & all_done & has, i, neff)
            work = (has & ~all_done)[:, None, None]
            live = j[None, :] < (cnt - i * CHUNK)[:, None]
            idx = torch.where(live, start[:, None] + i * CHUNK + j, 0)
            feat = torch.where(live[..., None], inst[idx], 0.0)
            w, contrib, T_out, done_out = _chunk_terms(
                feat, px, py, T, done, cfg.rect_test)

            def add(acc, c):
                return torch.where(work, acc + (w * feat[:, :, c, None]).sum(1, keepdim=True), acc)

            C0, C1, C2, D = add(C0, _FR), add(C1, _FG), add(C2, _FB2), add(D, _FD)
            A = torch.where(work, A + w.sum(1, keepdim=True), A)
            if cfg.contrib_stats:
                pos = (j + i * CHUNK + 1).to(torch.float32)[None, :, None]
                best = torch.where(contrib, pos, 0.0).amax(dim=1, keepdim=True)
                N = torch.where(work, torch.maximum(N, best), N)
            T = torch.where(work, T_out, T)
            done = torch.where(work, done_out, done)
        neff = torch.where(neff < 0, nch, neff).to(torch.float32)
        out[g0:g0 + len(t)] = torch.cat(
            [C0, C1, C2, D, A, T, N, neff[:, None, None].expand_as(T)], dim=1)
    return out


def composite_tiles(inst, sorted_start, tile_nchunks, cnt_allowed,
                    cfg: TileConfig):
    """K1 wrapper: composite every tile's sorted instance run.

    inst: [L, FEAT] float32 (the sorted instance features); sorted_start,
    tile_nchunks, cnt_allowed: [T] int32. Returns [T, 8, npix] float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, or raise.
    """
    if not inst.is_cuda:
        return composite_tiles_plain(inst, sorted_start, tile_nchunks,
                                     cnt_allowed, cfg)
    nt = cfg.num_tiles
    if inst.dtype != torch.float32 or inst.dim() != 2 or inst.shape[1] != FEAT:
        raise ValueError(f"inst must be float32 [L, {FEAT}], got "
                         f"{inst.dtype} {tuple(inst.shape)}")
    if not inst.is_contiguous() or inst.data_ptr() % 16:
        raise ValueError("inst must be contiguous and 16-byte aligned")
    for name, v in (("sorted_start", sorted_start),
                    ("tile_nchunks", tile_nchunks),
                    ("cnt_allowed", cnt_allowed)):
        if (v.device != inst.device or v.dtype != torch.int32
                or tuple(v.shape) != (nt,) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{nt}] tensor "
                             f"on {inst.device}")
    if cfg.npix % 256 or not 1 <= cfg.npix // 256 <= 8:
        raise ValueError(f"pixel block {cfg.pw}x{cfg.ph} is not 256..2048 "
                         "pixels in multiples of 256")
    out = torch.empty((nt, 8, cfg.npix), dtype=torch.float32, device=inst.device)
    fn = kernels.library("tile_forward")
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), sorted_start.data_ptr(), tile_nchunks.data_ptr(),
                 cnt_allowed.data_ptr(), out.data_ptr(), nt, cfg.grid_x, cfg.pw,
                 cfg.ph, int(cfg.rect_test), int(cfg.contrib_stats),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tile_forward kernel launch failed: CUDA error {err}")
    composite_tiles.launches += 1
    return out


composite_tiles.launches = 0  # K1 launches since the last reset


def prepare_tiles(
    pre: PreprocessedGaussians,
    width: int,
    height: int,
    *,
    max_instances: int = 2**20,
    max_chunks_per_tile: int = 64,
    tile_cull: bool = True,
    capacity_slack: float = 0.6,
    block_x: int = 1,
    block_y: int = 1,
    contrib_stats: bool = True,
) -> tuple[torch.Tensor, BinnedInstances, TileConfig]:
    """Bin a preprocessed gaussian set and gather its sorted instance table:
    returns (inst [max_instances, FEAT], binned, cfg), the inputs of K1."""
    # the JAX package rounds the per-tile chunk cap up to a multiple of 8
    # (a TPU tiling rule for its checkpoint array); binning reads the cap,
    # so the port rounds alike to keep its integer outputs equal
    max_chunks_per_tile = -(-max_chunks_per_tile // 8) * 8
    grid_x, grid_y = tile_grid(width, height)
    if block_x * block_y > 8:
        raise ValueError(f"block_x*block_y={block_x * block_y} > 8: the pixel "
                         "block exceeds the 2048 pixels a tile kernel takes")
    cfg = TileConfig(
        grid_x=-(-grid_x // block_x), grid_y=-(-grid_y // block_y),
        pw=TILE * block_x, ph=TILE * block_y,
        rect_test=block_x != 1 or block_y != 1, contrib_stats=contrib_stats)
    binned = bin_instances(
        pre, width, height, max_instances, max_chunks_per_tile,
        tile_cull=tile_cull, capacity_slack=capacity_slack,
        block_x=block_x, block_y=block_y)
    table = _build_rank_table(pre, binned.dorder, rect_rows=cfg.rect_test)
    inst = table.t()[binned.gid_sorted.long()].contiguous()
    return inst, binned, cfg


def tiles_to_image(tiles, cfg: TileConfig):
    """[T, 8, npix] tile rows -> [8, grid_y*ph, grid_x*pw] image rows."""
    return (tiles.reshape(cfg.grid_y, cfg.grid_x, 8, cfg.ph, cfg.pw)
            .permute(2, 0, 3, 1, 4)
            .reshape(8, cfg.grid_y * cfg.ph, cfg.grid_x * cfg.pw))


def render_tiles_raw(pre: PreprocessedGaussians, width: int, height: int, **kw):
    """Bin + render a preprocessed gaussian set to raw tile images.

    Returns (img [8, grid_y*ph, grid_x*pw] with rows (C0, C1, C2, D, A, T,
    n_contrib, neff), binned, cfg). Keywords as in `prepare_tiles`.
    """
    inst, binned, cfg = prepare_tiles(pre, width, height, **kw)
    tiles = composite_tiles(inst, binned.sorted_start, binned.tile_nchunks,
                            binned.cnt_allowed, cfg)
    return tiles_to_image(tiles, cfg), binned, cfg


def rasterize_tiles(
    means,
    scales,
    quats,
    opacities,
    shs,
    camera,
    bg_color=None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    active_mask=None,
    max_instances: int = 2**20,
    max_chunks_per_tile: int = 64,
    tile_cull: bool = True,
    capacity_slack: float = 0.6,
    block_x: int = 1,
    block_y: int = 1,
    contrib_stats: bool = True,
) -> RenderOutput:
    """Tile-binned rasterization (← rasterize_pallas), forward only;
    API-compatible with rasterize_naive.

    block_x/block_y set the SUPERTILE factor: each K1 block (and each
    binning cell) covers a (16*block_x) x (16*block_y) pixel block.
    """
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (means, scales, quats, opacities, shs)):
        raise NotImplementedError(
            "the tiles rasterizer is forward-only until the training slice "
            "ports the backward tile kernel (K2); render under "
            "torch.no_grad(), or use backend='naive' for gradients")
    H, W = camera.height, camera.width
    if bg_color is None:
        bg_color = torch.ones(3, dtype=means.dtype, device=means.device)

    pre = preprocess(
        means, scales, quats, opacities, shs, camera,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        active_mask=active_mask,
    )
    img, binned, cfg = render_tiles_raw(
        pre, W, H, max_instances=max_instances,
        max_chunks_per_tile=max_chunks_per_tile, tile_cull=tile_cull,
        capacity_slack=capacity_slack, block_x=block_x, block_y=block_y,
        contrib_stats=contrib_stats)
    # per-tile walked chunks (the early-stop vote), summed
    walked = img[7, ::cfg.ph, ::cfg.pw].sum().to(torch.int32)
    img = img[:, :H, :W]
    return RenderOutput(
        color=img[0:3] + img[5][None] * bg_color[:, None, None],
        depth=img[3],
        acc=img[4],
        final_T=img[5],
        n_contrib=img[6].to(torch.int32),
        radii=pre.radius.detach(),
        overflow=binned.overflow,
        num_instances=binned.num_instances,
        max_nchunks=binned.tile_nchunks.max(),
        walked_chunks=walked,
    )
