"""T2: ablation map of K1's per-chunk cost (counterpart of
tools/microbench_fwdablate.py; kernel `csrc/microbench_fwdablate.cu`).

K1's chunk walk over fabricated runs (60 x 34 tiles of 32 x 32 pixels, 4
uniform chunks of 128 instances per tile, no 1e-4 stop and no done flags),
as K1 walks it: pixels in K1's warp-uniform 16x8 patches, the rect test
once per warp before any pair math (the tool's rects are +-1e9, so it
always passes), K1's 4 blocks per SM. One piece is removed at a time:

  full      the walk as K1 does it
  noexp     G = power in place of exp(power)
  notrans   no shared staging: each instance read from global memory
  noaccept  no per-pixel accept test (contrib = alpha > 1e30, never true)
  noscan    no transmittance carried inside a chunk
  noaccum   only C0 += w, no colour, depth or alpha sums

The time each variant saves against full is what its piece costs. The
ablated variants are wrong renders on purpose. Inputs are drawn from
default_rng(0) as the JAX tool's build_inputs draws them. Run on the card:

    python -m gslivm_tpu_torch.tools.microbench_fwdablate
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert, kernels
from ..ops.binning import CHUNK
from ..ops.rasterize_tiles import (
    _FA,
    _FB,
    _FB2,
    _FC,
    _FD,
    _FG,
    _FO,
    _FR,
    _FX,
    _FX0,
    _FX1,
    _FY,
    _FY0,
    _FY1,
    FEAT,
    TileConfig,
    _check_inst,
    _check_int_rows,
    _chunk_feats,
    _cumprod_excl,
    _pixel_coords,
)
from .timing import PEAK_BYTES, PEAK_F32, device_time_ms

GX, GY = 60, 34
SIDE = 32
NPIX = SIDE * SIDE
NCH = 4  # uniform chunks per tile
VARIANTS = ("full", "noexp", "notrans", "noaccept", "noscan", "noaccum")
ACCEPT_THR = 1e30  # noaccept's contrib threshold, passed to the kernel
FLOPS_PER_PAIR = 15  # dx, dy, the conic quadratic, exp (2), alpha and tests
# the plain version steps as many tiles at once as keep one [tiles, CHUNK,
# NPIX] f32 array within this many elements
_PLAIN_GROUP_ELEMENTS = 1 << 24


def build_inputs(gx: int = GX, gy: int = GY, nch: int = NCH):
    """numpy (inst [16, L] feature-major, start, nch, cnt), drawn as
    tools/microbench_fwdablate.py:build_inputs draws them."""
    rng = np.random.default_rng(0)
    num_tiles = gx * gy
    total = num_tiles * nch * CHUNK
    inst = np.zeros((FEAT, total + 2 * CHUNK), np.float32)
    inst[_FX] = rng.uniform(0, gx * 32, inst.shape[1])
    inst[_FY] = rng.uniform(0, gy * 32, inst.shape[1])
    inst[_FA] = 2e-4
    inst[_FC] = 2e-4
    inst[_FO] = 0.02
    inst[_FR] = rng.uniform(0, 1, inst.shape[1])
    inst[_FX1] = 1e9
    inst[_FY1] = 1e9
    inst[_FX0] = -1e9
    inst[_FY0] = -1e9
    start = np.arange(num_tiles, dtype=np.int32) * (nch * CHUNK)
    return (inst, start, np.full((num_tiles,), nch, np.int32),
            np.full((num_tiles,), nch * CHUNK, np.int32))


def chunk_walk_plain(inst, start, nchunks, cnt, grid_x: int, variant: str = "full"):
    """The plain version: the JAX tool's per-chunk math (its prefix product
    T * cumprod_excl(1 - alpha_eff) and the min over contributors),
    vectorised over a group of tiles. Returns [T, 8, 1024] rows C0, C1,
    C2, D, A, T, T, T. notrans computes full's values (at the JAX tool's
    chunk-aligned offsets its variant does too)."""
    dev = inst.device
    nt = start.shape[0]
    cfg = TileConfig(grid_x=grid_x, grid_y=nt // grid_x, pw=SIDE, ph=SIDE)
    group = max(1, _PLAIN_GROUP_ELEMENTS // (CHUNK * NPIX))
    out = torch.empty((nt, 8, NPIX), dtype=torch.float32, device=dev)
    for g0 in range(0, nt, group):
        t = torch.arange(g0, min(g0 + group, nt), device=dev)
        px, py = _pixel_coords(t, cfg)
        s, n, c = start[t].long(), nchunks[t].long(), cnt[t].long()
        T = torch.ones_like(px)
        C0, C1, C2, D, A = (torch.zeros_like(px) for _ in range(5))
        for i in range(int(n.max()) if len(t) else 0):
            # rows past the run, or of tiles past their chunks, are zero:
            # opacity 0 composites as nothing in every variant
            feat, _, _ = _chunk_feats(inst, s, c, i, mask=i < n)

            def col(k):
                return feat[:, :, k, None]

            dx = col(_FX) - px
            dy = col(_FY) - py
            power = -0.5 * (col(_FA) * dx * dx + col(_FC) * dy * dy) - col(_FB) * dx * dy
            G = power if variant == "noexp" else torch.exp(power)
            alpha = torch.clamp(col(_FO) * G, max=0.99)
            if variant == "noaccept":
                one_minus_eff = 1.0 - alpha
                contrib = alpha > ACCEPT_THR
            else:
                contrib = ((power <= 0.0) & (alpha >= 1.0 / 255.0)
                           & (px >= col(_FX0)) & (px < col(_FX1))
                           & (py >= col(_FY0)) & (py < col(_FY1)))
                one_minus_eff = torch.where(contrib, 1.0 - alpha, torch.ones_like(alpha))
            if variant == "noscan":
                T_prev = T * one_minus_eff
            else:
                T_prev = T * _cumprod_excl(one_minus_eff)
            T_next = T_prev * (1.0 - alpha)
            w = torch.where(contrib, alpha * T_prev, torch.zeros_like(alpha))
            T = torch.where(contrib, T_next, T.expand_as(T_next)).amin(dim=1, keepdim=True)
            if variant == "noaccum":
                C0 = C0 + w.sum(dim=1, keepdim=True)
            else:
                C0 = C0 + (w * col(_FR)).sum(dim=1, keepdim=True)
                C1 = C1 + (w * col(_FG)).sum(dim=1, keepdim=True)
                C2 = C2 + (w * col(_FB2)).sum(dim=1, keepdim=True)
                D = D + (w * col(_FD)).sum(dim=1, keepdim=True)
                A = A + w.sum(dim=1, keepdim=True)
        out[g0:g0 + len(t)] = torch.cat([C0, C1, C2, D, A, T, T, T], dim=1)
    return out


def chunk_walk(inst, start, nchunks, cnt, grid_x: int, variant: str = "full"):
    """T2 wrapper: the variant's [T, 8, 1024] rows (see chunk_walk_plain).
    inst: [L, 16] float32; start, nchunks, cnt: [T] int32, T a multiple of
    grid_x. CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, or raise."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    nt = start.shape[0]
    if grid_x < 1 or nt % grid_x:
        raise ValueError(f"{nt} tiles do not fill rows of grid_x={grid_x}")
    if not inst.is_cuda:
        return chunk_walk_plain(inst, start, nchunks, cnt, grid_x, variant)
    _check_inst(inst)
    _check_int_rows(nt, inst.device, start=start, nchunks=nchunks, cnt=cnt)
    out = torch.empty((nt, 8, NPIX), dtype=torch.float32, device=inst.device)
    fn = kernels.library("microbench_fwdablate")
    with torch.cuda.device(inst.device):
        err = fn(inst.data_ptr(), start.data_ptr(), nchunks.data_ptr(), cnt.data_ptr(),
                 out.data_ptr(), nt, grid_x, VARIANTS.index(variant), ACCEPT_THR,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"microbench_fwdablate kernel launch failed: CUDA error {err}")
    chunk_walk.launches += 1
    return out


chunk_walk.launches = 0  # T2 launches since the last reset


def work(nchunks, cnt) -> dict:
    """The pairs, flops and bytes of full's walk, and its bound in ms: the
    walked instances read once (64 B each), the rows written once, three
    ints per tile read."""
    walked = int(torch.minimum(cnt.long(), nchunks.long() * CHUNK).sum())
    nt = cnt.shape[0]
    pairs = walked * NPIX
    flops = pairs * FLOPS_PER_PAIR
    moved = walked * FEAT * 4 + nt * 8 * NPIX * 4 + nt * 3 * 4
    t_ops, t_bytes = flops / PEAK_F32, moved / PEAK_BYTES
    return {"pairs": pairs, "flops": flops, "bytes": moved,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def device_inputs(device="cuda", **kw):
    """build_inputs carried onto `device` in the port's row layout."""
    inst, *ints = build_inputs(**kw)
    inst = convert.inst_from_numpy(inst, device=device)
    return (inst, *(torch.from_numpy(a).to(inst.device) for a in ints))


def run(variant: str, device="cuda", reps: int = 20, inputs=None) -> dict:
    """Time one variant on the card at the tool's size."""
    inst, start, nch, cnt = inputs if inputs is not None else device_inputs(device)
    ms = device_time_ms(lambda: chunk_walk(inst, start, nch, cnt, GX, variant),
                        reps=reps, device=device)
    chunks = int(nch.long().sum())
    return {"variant": variant, "ms": ms, "us_per_chunk": ms * 1e3 / chunks}


def main():
    inputs = device_inputs()
    base = run("full", inputs=inputs)
    w = work(inputs[2], inputs[3])
    print(f"{'full':10s} {base['ms']:8.4f} ms ({base['us_per_chunk']:.4f} us/chunk; "
          f"bound {w['bound_ms']:.4f} ms by {w['bound_by']})", flush=True)
    for v in VARIANTS[1:]:
        r = run(v, inputs=inputs)
        print(f"{v:10s} {r['ms']:8.4f} ms ({r['us_per_chunk']:.4f} us/chunk)"
              f"   -> {v} saves {base['us_per_chunk'] - r['us_per_chunk']:+.4f} us/chunk",
              flush=True)


if __name__ == "__main__":
    main()
