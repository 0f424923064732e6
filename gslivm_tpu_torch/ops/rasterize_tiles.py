"""Tile rasterizer, forward and backward (port of
gslivm_tpu/ops/rasterize_pallas.py).

Pipeline: preprocess -> bin_instances (supertile runs, depth-sorted) ->
the [16, P] rank-ordered feature table -> gather into the sorted instance
layout -> the tile compositor K1 (`csrc/tile_forward.cu`) -> image. For a
gradient, K1 also writes its chunk-start transmittance checkpoints, and
the backward tile kernel K2 (`csrc/tile_backward.cu`) turns the image
cotangents into the table's gradient, summed per gaussian by the rank id
inside the kernel; autograd carries it through the rank permutation and
`preprocess` to the parameters.

`composite_tiles` / `composite_tiles_bwd` launch K1 / K2 on CUDA tensors
and take their plain PyTorch versions only for CPU tensors: K1's is
`composite_tiles_plain`, K2's is `composite_tiles_bwd_plain` (one gradient
row per instance, the JAX kernel's output) followed by
`scatter_instance_grads` (the per-gaussian sum). The plain versions
repeat the TPU kernels' per-chunk math (`_chunk_terms`) vectorised over a
group of tiles, including its Hillis-Steele prefix scans, so that they are
the closest CPU twins of the JAX kernels run in interpret mode.

A render may cover a band of supertile rows only (the pixel axis of the
sharded step, parallel/sharding.py): binning clips to the band, and
mean2d.y and the rect rows move into band-local pixels before the rank
table is built, so K1 and K2 render a band as they render a whole image.

The JAX kernels' CHUNK-aligned gradient layout (`pad_cols`/`poff`) and its
compacted variant (`grad_cols`) serve the TPU's aligned DMA writes and its
per-index scatter cost; K2 adds each walked instance's gradient into its
gaussian's column instead, so the port has neither.
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
# pixels, used only in supertile mode (the per-pixel rect test); they are
# multiples of 16, which lets K1 and K2 test them once per warp
(_FX, _FY, _FA, _FB, _FC, _FO, _FR, _FG, _FB2, _FD,
 _FX0, _FX1, _FY0, _FY1) = range(14)
_FID = 14  # the column's own rank id (exact f32): K2 adds each instance's
           # gradient at it, as the plain per-gaussian scatter does
# the plain compositors step as many tiles at once as keep one [tiles, CHUNK,
# npix] f32 array within this many elements (64 MB), so that a 1080p frame
# fits on the card
_PLAIN_GROUP_ELEMENTS = 1 << 24


class TileConfig(NamedTuple):
    """Static geometry of a tile render: grid_x * grid_y blocks of pw x ph
    pixels (pw = 16 * block_x, ph = 16 * block_y). With rect_test the
    kernels K1 and K2 take the instances' tile-rect columns (_FX0.._FY1) to
    be multiples of 16, as _build_rank_table makes them, and test them once
    per warp."""

    grid_x: int
    grid_y: int
    pw: int = TILE
    ph: int = TILE
    rect_test: bool = False      # supertile mode: per-pixel tile-rect test
    contrib_stats: bool = True   # False renders n_contrib as zeros
    max_chunks: int = 64         # checkpoint rows per tile (>= tile_nchunks)

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def npix(self) -> int:
        return self.pw * self.ph


class _PermuteCols(torch.autograd.Function):
    """x[:, order] whose backward is a gather by the inverse permutation
    (rasterize_pallas.py:_permute_cols), not a scatter-add."""

    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(order)
        return x[:, order]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return g[:, inv], None


def _build_rank_table(pre: PreprocessedGaussians, dorder, rect_rows: bool = False,
                      y_shift: int = 0):
    """The [FEAT, P] per-gaussian screen-feature table in DEPTH-RANK column
    order (differentiable). rect_rows appends the 4 tile-rect pixel bounds
    (supertile mode's rect test) as exact f32 values; row _FID is the
    column's rank id. Invalid gaussians enter with opacity 0. y_shift (a
    band's first pixel row, a multiple of 16) moves mean2d.y and the rect
    rows into band-local pixels; the rect columns stay multiples of 16."""
    rows = [
        pre.mean2d[:, 0],
        pre.mean2d[:, 1] - y_shift if y_shift else pre.mean2d[:, 1],
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
            (pre.rect_min[:, 1] * TILE - y_shift).to(torch.float32),
            (pre.rect_max[:, 1] * TILE - y_shift).to(torch.float32),
        ]
    n = dorder.shape[0]
    table = _PermuteCols.apply(torch.stack(rows, dim=0), dorder.long())
    zeros = table.new_zeros
    return torch.cat([
        table,
        zeros((_FID - len(rows), n)),
        torch.arange(n, dtype=table.dtype, device=table.device)[None, :],
        zeros((FEAT - _FID - 1, n)),
    ], dim=0)


def _scan_rows(x, op, fill: float):
    """Inclusive scan along dim 1 of a [G, CHUNK, npix] array: the TPU
    kernel's Hillis-Steele scan (shifts filled with the identity)."""
    n = x.shape[1]
    s = 1
    while s < n:
        x = op(x, torch.cat([torch.full_like(x[:, :s], fill), x[:, :n - s]], dim=1))
        s *= 2
    return x


def _cumprod_excl(x):
    """Exclusive prefix product along dim 1 (rasterize_pallas._cumprod_rows)."""
    x = _scan_rows(x, torch.mul, 1.0)
    return torch.cat([torch.ones_like(x[:, :1]), x[:, :-1]], dim=1)


def _suffix_excl(x):
    """Sum over strictly later rows along dim 1: S[k] = sum_{j>k} x[j]
    (rasterize_pallas._suffix_excl: the total minus the inclusive scan)."""
    return x.sum(dim=1, keepdim=True) - _scan_rows(x, torch.add, 0.0)


class _Chunk(NamedTuple):
    dx: torch.Tensor         # [G, CHUNK, npix]
    dy: torch.Tensor
    G: torch.Tensor          # exp(power)
    raw_alpha: torch.Tensor  # opacity * G
    alpha: torch.Tensor      # min(0.99, raw_alpha)
    contrib: torch.Tensor
    w: torch.Tensor          # alpha * T_prev where contrib, else 0
    T_prev: torch.Tensor
    T_out: torch.Tensor      # [G, 1, npix]
    done_out: torch.Tensor


def _chunk_terms(feat, px, py, T_in, done_in, rect_test: bool) -> _Chunk:
    """One chunk of the TPU kernels' math (rasterize_pallas.py:_chunk_terms),
    for a group of tiles at once.

    feat: [G, CHUNK, FEAT]; px/py: [G, 1, npix]; T_in/done_in: [G, 1, npix].
    """
    def col(i):
        return feat[:, :, i, None]

    dx = col(_FX) - px
    dy = col(_FY) - py
    power = -0.5 * (col(_FA) * dx * dx + col(_FC) * dy * dy) - col(_FB) * dx * dy
    G = torch.exp(power)
    raw_alpha = col(_FO) * G
    alpha = torch.clamp(raw_alpha, max=0.99)
    accepted = (power <= 0.0) & (alpha >= 1.0 / 255.0)
    if rect_test:
        accepted = (accepted & (px >= col(_FX0)) & (px < col(_FX1))
                    & (py >= col(_FY0)) & (py < col(_FY1)))
    one_minus_eff = torch.where(accepted, 1.0 - alpha, torch.ones_like(alpha))

    T_prev = T_in * _cumprod_excl(one_minus_eff)
    T_next = T_prev * (1.0 - alpha)
    would_stop = accepted & (T_next < 1e-4)
    # the early-stop latch needs no scan: once T_prev*(1-alpha) < 1e-4 fires,
    # every later accepted splat fails the same test (T_prev non-increasing)
    contrib = accepted & ~done_in & (T_next >= 1e-4)
    w = torch.where(contrib, alpha * T_prev, torch.zeros_like(alpha))
    T_out = torch.where(contrib, T_next, T_in.expand_as(T_next)).amin(dim=1, keepdim=True)
    done_out = done_in | would_stop.any(dim=1, keepdim=True)
    return _Chunk(dx, dy, G, raw_alpha, alpha, contrib, w, T_prev, T_out, done_out)


def _pixel_coords(t, cfg: TileConfig):
    """[G, 1, npix] f32 pixel coordinates of tiles t (row-major blocks)."""
    p = torch.arange(cfg.npix, device=t.device)
    px = ((t % cfg.grid_x)[:, None] * cfg.pw + p % cfg.pw).to(torch.float32)[:, None]
    py = ((t // cfg.grid_x)[:, None] * cfg.ph + p // cfg.pw).to(torch.float32)[:, None]
    return px, py


def _chunk_feats(inst, start, cnt, i: int, mask=None):
    """Chunk i of each tile's run as [G, CHUNK, FEAT] (rows past the run, or
    of tiles outside `mask`, are zero) and their slots in `inst`."""
    j = torch.arange(CHUNK, device=inst.device)
    live = j[None, :] < (cnt - i * CHUNK)[:, None]
    if mask is not None:
        live = live & mask[:, None]
    idx = torch.where(live, start[:, None] + i * CHUNK + j, 0)
    return torch.where(live[..., None], inst[idx], 0.0), idx, live


def composite_tiles_plain(inst, sorted_start, tile_nchunks, cnt_allowed,
                          cfg: TileConfig, save_ckpt: bool = False):
    """The plain PyTorch version of K1: [L, FEAT] sorted instances ->
    [T, 8, npix] rows (C_r, C_g, C_b, D, A, T_final, n_contrib, neff), and
    with save_ckpt also the [T, max_chunks, npix] chunk-start checkpoints
    (T, negated once the pixel is done; rows of unwalked chunks are 0).

    A loop over chunk index, vectorised over a group of tiles at a time."""
    dev = inst.device
    T_all, npix = cfg.num_tiles, cfg.npix
    group = max(1, _PLAIN_GROUP_ELEMENTS // (CHUNK * npix))
    out = torch.empty((T_all, 8, npix), dtype=torch.float32, device=dev)
    ckpt = None
    if save_ckpt:
        if T_all and int(tile_nchunks.max()) > cfg.max_chunks:
            raise ValueError(f"tile_nchunks exceeds max_chunks={cfg.max_chunks}")
        ckpt = torch.zeros((T_all, cfg.max_chunks, npix), dtype=torch.float32,
                           device=dev)
    j = torch.arange(CHUNK, device=dev)
    for g0 in range(0, T_all, group):
        t = torch.arange(g0, min(g0 + group, T_all), device=dev)
        px, py = _pixel_coords(t, cfg)
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
            if ckpt is not None:
                rows = ckpt[g0:g0 + len(t), i]
                ckpt[g0:g0 + len(t), i] = torch.where(
                    work[:, 0], torch.where(done, -T, T)[:, 0], rows)
            feat, _, _ = _chunk_feats(inst, start, cnt, i)
            m = _chunk_terms(feat, px, py, T, done, cfg.rect_test)

            def add(acc, c):
                return torch.where(work, acc + (m.w * feat[:, :, c, None]).sum(1, keepdim=True), acc)

            C0, C1, C2, D = add(C0, _FR), add(C1, _FG), add(C2, _FB2), add(D, _FD)
            A = torch.where(work, A + m.w.sum(1, keepdim=True), A)
            if cfg.contrib_stats:
                pos = (j + i * CHUNK + 1).to(torch.float32)[None, :, None]
                best = torch.where(m.contrib, pos, 0.0).amax(dim=1, keepdim=True)
                N = torch.where(work, torch.maximum(N, best), N)
            T = torch.where(work, m.T_out, T)
            done = torch.where(work, m.done_out, done)
        neff = torch.where(neff < 0, nch, neff).to(torch.float32)
        out[g0:g0 + len(t)] = torch.cat(
            [C0, C1, C2, D, A, T, N, neff[:, None, None].expand_as(T)], dim=1)
    return (out, ckpt) if save_ckpt else out


def _check_int_rows(nt: int, device, **rows):
    for name, v in rows.items():
        if (v.device != device or v.dtype != torch.int32
                or tuple(v.shape) != (nt,) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [{nt}] tensor "
                             f"on {device}")


def _check_inst(inst):
    if inst.dtype != torch.float32 or inst.dim() != 2 or inst.shape[1] != FEAT:
        raise ValueError(f"inst must be float32 [L, {FEAT}], got "
                         f"{inst.dtype} {tuple(inst.shape)}")
    if not inst.is_contiguous() or inst.data_ptr() % 16:
        raise ValueError("inst must be contiguous and 16-byte aligned")


def _check_inst_and_block(inst, cfg: TileConfig):
    _check_inst(inst)
    # the kernels tile a block with whole 16x16 tiles (tile_common.cuh)
    if (cfg.pw % TILE or cfg.ph % TILE or cfg.npix % 256
            or not 1 <= cfg.npix // 256 <= 8):
        raise ValueError(f"pixel block {cfg.pw}x{cfg.ph} is not 256..2048 "
                         f"pixels in whole {TILE}x{TILE} tiles")


def composite_tiles(inst, sorted_start, tile_nchunks, cnt_allowed,
                    cfg: TileConfig, save_ckpt: bool = False):
    """K1 wrapper: composite every tile's sorted instance run.

    inst: [L, FEAT] float32 (the sorted instance features); sorted_start,
    tile_nchunks, cnt_allowed: [T] int32, every tile_nchunks <= cfg.max_chunks
    (binning caps them). Returns [T, 8, npix] float32, and with save_ckpt
    also the [T, max_chunks, npix] chunk-start checkpoints (rows of
    unwalked chunks are left unwritten on the card). CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream,
    or raise.
    """
    if not inst.is_cuda:
        return composite_tiles_plain(inst, sorted_start, tile_nchunks,
                                     cnt_allowed, cfg, save_ckpt)
    nt = cfg.num_tiles
    _check_inst_and_block(inst, cfg)
    _check_int_rows(nt, inst.device, sorted_start=sorted_start,
                    tile_nchunks=tile_nchunks, cnt_allowed=cnt_allowed)
    out = torch.empty((nt, 8, cfg.npix), dtype=torch.float32, device=inst.device)
    ckpt = (torch.empty((nt, cfg.max_chunks, cfg.npix), dtype=torch.float32,
                        device=inst.device) if save_ckpt else None)
    fn = kernels.library("tile_forward")
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), sorted_start.data_ptr(), tile_nchunks.data_ptr(),
                 cnt_allowed.data_ptr(), out.data_ptr(),
                 ckpt.data_ptr() if save_ckpt else None, nt, cfg.grid_x, cfg.pw,
                 cfg.ph, cfg.max_chunks, int(cfg.rect_test),
                 int(cfg.contrib_stats), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tile_forward kernel launch failed: CUDA error {err}")
    composite_tiles.launches += 1
    return (out, ckpt) if save_ckpt else out


composite_tiles.launches = 0  # K1 launches since the last reset


def composite_tiles_bwd_plain(inst, sorted_start, cnt_allowed, g_tiles,
                              fwd_tiles, ckpt, cfg: TileConfig,
                              depth_grad: bool = True):
    """The JAX kernel's per-instance rows (rasterize_pallas.py:_bwd_kernel);
    followed by scatter_instance_grads, the plain version of K2. The
    cotangents g_tiles [T, 8, npix] of K1's rows, K1's output fwd_tiles
    and its checkpoints ckpt -> one gradient row per instance, [L, FEAT]:
    d mean2d (2), d conic (3), d opacity, d rgb (3), d depth (0 without
    depth_grad), zeros, the rank id in column _FID. Rows of instances in
    unwalked chunks (from each tile's neff on) are zero with id 0.

    Each tile's chunks are walked from neff-1 down, vectorised over a group
    of tiles, with the JAX kernel's prefix product, suffix scan and pixel
    sums."""
    dev = inst.device
    T_all, npix = cfg.num_tiles, cfg.npix
    group = max(1, _PLAIN_GROUP_ELEMENTS // (CHUNK * npix))
    out = torch.zeros((inst.shape[0], FEAT), dtype=torch.float32, device=dev)
    neff_all = fwd_tiles[:, 7, 0].long()
    for g0 in range(0, T_all, group):
        t = torch.arange(g0, min(g0 + group, T_all), device=dev)
        px, py = _pixel_coords(t, cfg)
        start, cnt, neff = sorted_start[t].long(), cnt_allowed[t].long(), neff_all[t]
        g = g_tiles[t]
        gC0, gC1, gC2, gD, gA = (g[:, r:r + 1] for r in range(5))
        gTT = g[:, 5:6] * fwd_tiles[t, 5:6]
        Wpsi = torch.zeros_like(px)
        for i in reversed(range(int(neff.max()) if len(t) else 0)):
            work = i < neff
            feat, idx, live = _chunk_feats(inst, start, cnt, i, mask=work)
            T_signed = ckpt[t, i][:, None]
            m = _chunk_terms(feat, px, py, T_signed.abs(), T_signed < 0.0,
                             cfg.rect_test)

            def col(c):
                return feat[:, :, c, None]

            # the five per-output cotangents enter dL/dalpha only through
            # psi = gC . rgb + gA (+ gD d): one fused suffix sum of w * psi
            psi = gC0 * col(_FR) + gC1 * col(_FG) + gC2 * col(_FB2) + gA
            if depth_grad:
                psi = psi + gD * col(_FD)
            S = _suffix_excl(m.w * psi) + Wpsi
            inv = 1.0 / torch.clamp(1.0 - m.alpha, min=1e-6)
            dLda = torch.where(m.contrib, m.T_prev * psi - (S + gTT) * inv, 0.0)
            # min(0.99, .) subgradient gate (rasterize_pallas.py module doc)
            not_clamped = m.raw_alpha < 0.99
            d_op = torch.where(not_clamped, m.G, 0.0) * dLda
            d_power = torch.where(not_clamped, col(_FO), 0.0) * dLda * m.G
            u = d_power * m.dx
            v = d_power * m.dy

            def psum(x):
                return x.sum(dim=2)

            su, sv = psum(u), psum(v)
            ca, cb, cc = feat[:, :, _FA], feat[:, :, _FB], feat[:, :, _FC]
            zero = torch.zeros_like(su)
            rows = torch.stack([
                -(ca * su + cb * sv),          # d mean2d.x
                -(cc * sv + cb * su),          # d mean2d.y
                -0.5 * psum(u * m.dx),         # d conic a
                -psum(u * m.dy),               # d conic b
                -0.5 * psum(v * m.dy),         # d conic c
                psum(d_op),                    # d opacity
                psum(gC0 * m.w),               # d color r
                psum(gC1 * m.w),               # d color g
                psum(gC2 * m.w),               # d color b
                psum(gD * m.w) if depth_grad else zero,  # d depth
                zero, zero, zero, zero,
                feat[:, :, _FID],              # the rank id
                zero,
            ], dim=2)
            out[idx[live]] = rows[live]
            Wpsi = torch.where(work[:, None, None],
                               Wpsi + (m.w * psi).sum(dim=1, keepdim=True), Wpsi)
    return out


def composite_tiles_bwd(inst, sorted_start, cnt_allowed, g_tiles, fwd_tiles,
                        ckpt, cfg: TileConfig, num_gaussians: int,
                        depth_grad: bool = True):
    """K2 wrapper: the rank table's gradient [FEAT, num_gaussians] from the
    cotangents g_tiles [T, 8, npix] of K1's output fwd_tiles and K1's
    checkpoints ckpt [T, max_chunks, npix]: each walked instance's gradient
    row (see composite_tiles_bwd_plain) summed by its rank id (column _FID,
    in [0, num_gaussians)), as scatter_instance_grads sums the plain rows.
    CPU tensors take that plain pair; CUDA tensors launch the kernel on the
    current stream, or raise. On the card a gaussian instanced in several
    tiles is summed by atomics in run-to-run order (f32 rounding)."""
    if not inst.is_cuda:
        rows = composite_tiles_bwd_plain(inst, sorted_start, cnt_allowed,
                                         g_tiles, fwd_tiles, ckpt, cfg,
                                         depth_grad)
        return scatter_instance_grads(rows, num_gaussians, depth_grad)
    nt = cfg.num_tiles
    _check_inst_and_block(inst, cfg)
    _check_int_rows(nt, inst.device, sorted_start=sorted_start,
                    cnt_allowed=cnt_allowed)
    for name, v, rows in (("g_tiles", g_tiles, 8), ("fwd_tiles", fwd_tiles, 8),
                          ("ckpt", ckpt, cfg.max_chunks)):
        if (v.device != inst.device or v.dtype != torch.float32
                or tuple(v.shape) != (nt, rows, cfg.npix) or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[{nt}, {rows}, {cfg.npix}] tensor on {inst.device}")
    out = torch.zeros((FEAT, num_gaussians), dtype=torch.float32, device=inst.device)
    fn = kernels.library("tile_backward")
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), sorted_start.data_ptr(), cnt_allowed.data_ptr(),
                 g_tiles.data_ptr(), fwd_tiles.data_ptr(), ckpt.data_ptr(),
                 out.data_ptr(), num_gaussians, nt, cfg.grid_x, cfg.pw, cfg.ph,
                 cfg.max_chunks, int(cfg.rect_test), int(depth_grad),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tile_backward kernel launch failed: CUDA error {err}")
    composite_tiles_bwd.launches += 1
    return out


composite_tiles_bwd.launches = 0  # K2 launches since the last reset


def scatter_instance_grads(rows, num_gaussians: int, depth_grad: bool = True):
    """Per-instance gradient rows [L, FEAT] -> the rank table's gradient
    [FEAT, P]: rows summed per gaussian by the rank id in column _FID
    (rasterize_pallas._render_from_table_bwd). Unwalked rows carry id 0
    and zero gradients. The plain version of K2's per-gaussian sum."""
    ndg = 10 if depth_grad else 9  # the depth row is skipped with depth_grad
    dg = rows.new_zeros((num_gaussians, ndg)).index_add_(
        0, rows[:, _FID].long(), rows[:, :ndg])
    return torch.cat([dg.t(), rows.new_zeros((FEAT - ndg, num_gaussians))], dim=0)


class _RenderFromTable(torch.autograd.Function):
    """The tile render as one differentiable function of the rank table
    (rasterize_pallas._render_from_table with its custom VJP): K1 with
    checkpoints forward, K2 (summed per gaussian) backward."""

    @staticmethod
    def forward(ctx, table, gid_sorted, sorted_start, tile_nchunks,
                cnt_allowed, cfg, depth_grad):
        inst = table.t()[gid_sorted.long()].contiguous()
        tiles, ckpt = composite_tiles(inst, sorted_start, tile_nchunks,
                                      cnt_allowed, cfg, save_ckpt=True)
        ctx.save_for_backward(inst, sorted_start, cnt_allowed, tiles, ckpt)
        ctx.cfg, ctx.depth_grad, ctx.n = cfg, depth_grad, table.shape[1]
        return tiles

    @staticmethod
    def backward(ctx, g_tiles):
        inst, sorted_start, cnt_allowed, tiles, ckpt = ctx.saved_tensors
        d_table = composite_tiles_bwd(inst, sorted_start, cnt_allowed,
                                      g_tiles.contiguous(), tiles, ckpt, ctx.cfg,
                                      ctx.n, ctx.depth_grad)
        return d_table, None, None, None, None, None, None


def render_from_table(table, binned: BinnedInstances, cfg: TileConfig,
                      depth_grad: bool = True):
    """[T, 8, npix] tiles of the rank table: differentiable in the table when
    a gradient is asked (K1 with checkpoints, then K2), else K1 alone."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _RenderFromTable.apply(table, binned.gid_sorted,
                                      binned.sorted_start, binned.tile_nchunks,
                                      binned.cnt_allowed, cfg, depth_grad)
    inst = table.t()[binned.gid_sorted.long()].contiguous()
    return composite_tiles(inst, binned.sorted_start, binned.tile_nchunks,
                           binned.cnt_allowed, cfg)


def bin_tiles(
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
    tile_band: tuple[int, int] | None = None,
    band_rows: int | None = None,
    band_start: int | None = None,
) -> tuple[torch.Tensor, BinnedInstances, TileConfig]:
    """Bin a preprocessed gaussian set: returns (the [FEAT, P] rank table,
    binned, cfg). A band, in supertile rows, is tile_band=(y0, y1) or
    band_rows=h with band_start=y0 (rasterize_tiles tells the two modes
    apart); cfg.grid_y is then the band's rows and the table is in
    band-local pixels."""
    # the JAX package rounds the per-tile chunk cap up to a multiple of 8
    # (a TPU tiling rule for its checkpoint array); binning reads the cap,
    # so the port rounds alike to keep its integer outputs equal
    max_chunks_per_tile = -(-max_chunks_per_tile // 8) * 8
    grid_x, grid_y = tile_grid(width, height)
    if block_x * block_y > 8:
        raise ValueError(f"block_x*block_y={block_x * block_y} > 8: the pixel "
                         "block exceeds the 2048 pixels a tile kernel takes")
    y0, n_rows = _band(-(-grid_y // block_y), tile_band, band_rows, band_start)
    cfg = TileConfig(
        grid_x=-(-grid_x // block_x), grid_y=n_rows,
        pw=TILE * block_x, ph=TILE * block_y,
        rect_test=block_x != 1 or block_y != 1, contrib_stats=contrib_stats,
        max_chunks=max_chunks_per_tile)
    banded = tile_band is not None or band_rows is not None
    binned = bin_instances(
        pre, width, height, max_instances, max_chunks_per_tile,
        tile_cull=tile_cull, capacity_slack=capacity_slack,
        block_x=block_x, block_y=block_y,
        band_start=y0 if banded else None, band_rows=n_rows if banded else None)
    table = _build_rank_table(pre, binned.dorder, rect_rows=cfg.rect_test,
                              y_shift=y0 * cfg.ph)
    return table, binned, cfg


def _band(sgrid_y: int, tile_band, band_rows, band_start) -> tuple[int, int]:
    """(first supertile row, rows) of a render: the whole image, a static
    tile_band=(y0, y1), or band_rows rows from band_start."""
    if band_rows is not None:
        if tile_band is not None or band_start is None:
            raise ValueError("band_rows goes with band_start, not tile_band")
        return int(band_start), int(band_rows)
    if band_start is not None:
        raise ValueError("band_start needs band_rows")
    if tile_band is not None:
        y0, y1 = (int(v) for v in tile_band)
        if not 0 <= y0 < y1 <= sgrid_y:
            raise ValueError(f"tile_band {tile_band} is not inside [0, {sgrid_y})")
        return y0, y1 - y0
    return 0, sgrid_y


def prepare_tiles(pre: PreprocessedGaussians, width: int, height: int, **kw):
    """Bin a preprocessed gaussian set and gather its sorted instance table:
    returns (inst [max_instances, FEAT], binned, cfg), the inputs of K1.
    Keywords as in `bin_tiles`."""
    table, binned, cfg = bin_tiles(pre, width, height, **kw)
    inst = table.t()[binned.gid_sorted.long()].contiguous()
    return inst, binned, cfg


def tiles_to_image(tiles, cfg: TileConfig):
    """[T, 8, npix] tile rows -> [8, grid_y*ph, grid_x*pw] image rows."""
    return (tiles.reshape(cfg.grid_y, cfg.grid_x, 8, cfg.ph, cfg.pw)
            .permute(2, 0, 3, 1, 4)
            .reshape(8, cfg.grid_y * cfg.ph, cfg.grid_x * cfg.pw))


def render_tiles_raw(pre: PreprocessedGaussians, width: int, height: int,
                     depth_grad: bool = True, **kw):
    """Bin + render a preprocessed gaussian set to raw tile images.

    Returns (img [8, grid_y*ph, grid_x*pw] with rows (C0, C1, C2, D, A, T,
    n_contrib, neff), binned, cfg). Rows 0-5 are differentiable, the
    transmittance T included (the depth-slab merge of parallel/primitive.py
    differentiates through it); with depth_grad=False the backward skips
    the depth term. Keywords as in `bin_tiles`; with a band, img covers the
    band's rows only (cfg.grid_y = its rows).
    """
    table, binned, cfg = bin_tiles(pre, width, height, **kw)
    tiles = render_from_table(table, binned, cfg, depth_grad)
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
    depth_grad: bool = True,
    contrib_stats: bool = True,
    tile_band: tuple[int, int] | None = None,
    band_rows: int | None = None,
    band_start: int | None = None,
) -> RenderOutput:
    """Tile-binned rasterization (← rasterize_pallas), differentiable in all
    five inputs; API-compatible with rasterize_naive.

    block_x/block_y set the SUPERTILE factor: each K1 block (and each
    binning cell) covers a (16*block_x) x (16*block_y) pixel block.
    depth_grad=False lets the backward skip the depth term (the caller
    drops the depth cotangent anyway). final_T, n_contrib and radii carry
    no gradient.

    Two banded modes (the pixel axis of the sharded step), in supertile rows:
      tile_band=(y0, y1): the output keeps the full image shape; rows
        outside the band are background with T = 1.
      band_rows=h, band_start=y0: the output holds the band only,
        [.., h*16*block_y, W] (not cropped to the image height).
    """
    H, W = camera.height, camera.width
    if bg_color is None:
        bg_color = torch.ones(3, dtype=means.dtype, device=means.device)

    pre = preprocess(
        means, scales, quats, opacities, shs, camera,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        active_mask=active_mask,
    )
    img, binned, cfg = render_tiles_raw(
        pre, W, H, depth_grad=depth_grad, max_instances=max_instances,
        max_chunks_per_tile=max_chunks_per_tile, tile_cull=tile_cull,
        capacity_slack=capacity_slack, block_x=block_x, block_y=block_y,
        contrib_stats=contrib_stats, tile_band=tile_band, band_rows=band_rows,
        band_start=band_start)
    # per-tile walked chunks (the early-stop vote), summed
    walked = img[7, ::cfg.ph, ::cfg.pw].detach().sum().to(torch.int32)
    if band_rows is not None:
        img = img[:, :, :W]
    else:
        if tile_band is not None:  # embed: background (T = 1) outside the band
            sgrid_y = -(-tile_grid(W, H)[1] // block_y)
            y0, y1 = tile_band
            bg = img.new_zeros((8, (sgrid_y - (y1 - y0)) * cfg.ph, img.shape[2]))
            bg[5] = 1.0
            top, bottom = bg[:, :y0 * cfg.ph], bg[:, y0 * cfg.ph:]
            img = torch.cat([top, img, bottom], dim=1)
        img = img[:, :H, :W]
    return RenderOutput(
        color=img[0:3] + img[5][None] * bg_color[:, None, None],
        depth=img[3],
        acc=img[4],
        final_T=img[5].detach(),
        n_contrib=img[6].detach().to(torch.int32),
        radii=pre.radius.detach(),
        overflow=binned.overflow,
        num_instances=binned.num_instances,
        max_nchunks=binned.tile_nchunks.max(),
        walked_chunks=walked,
    )
