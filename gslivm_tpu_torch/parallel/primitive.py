"""Primitive-sharded rendering: the "gauss" axis without a parameter gather
(port of gslivm_tpu/parallel/primitive.py).

  1. Each rank preprocesses only its own parameter shard (P/g gaussians).
  2. Depth-slab re-partition: the depth keys (4 bytes a gaussian, the only
     O(P) quantity every rank holds) are all_gathered and ranked by a
     stable argsort, so every gaussian has a global front-to-back rank;
     ONE all_to_all of the 15-float screen rows moves each gaussian to the
     rank that owns its slab of ranks, at its rank offset there. Slabs are
     contiguous rank ranges, so they are depth-disjoint and a slab's local
     depth order is the global order (ties break by global index).
  3. Each rank bins and renders its slab over its pixel band with the tile
     kernels (K1 forward, K2 backward): premultiplied (C, D, A) and the
     transmittance T, all differentiable.
  4. Compositing over depth-disjoint groups is associative:
        C = C_a + T_a * C_b,  D and A alike,  T = T_a * T_b,
     so one all_gather of the 6-row partials over "gauss" and a front-to-
     back fold give the exact composite.
  5. Gradients go back through the fold, the partial all_gather (a
     reduce-scatter) and the all_to_all (the reverse exchange); the
     convention is collectives.py's.

Deviation from the single-device render, as in the JAX package: the
early-stop latch fires per slab (when the next splat would take the slab's
own T below 1e-4), so a slab cannot see that the slabs in front of it
already saturated a pixel, and the one-pass walk's stop on the product of
all slabs' T is not taken either. Against the composite of every splat
(no stop), the one pass drops at most the light behind its final T, and
each slab that stopped drops at most the light behind its own final T
times the T in front of it; a splat stops a walk only where T is below
STOP_T = 1e-4 / (1 - 0.99) (the stopping splat's alpha is at most 0.99),
not 1e-4 as the JAX package's note says. `fold_stop_bound` sums these
transmittances per pixel: the fold and the one-pass render differ by at
most that times the largest colour (or depth) of a splat, plus f32
rounding, and agree to rounding where no walk stopped.

The functions take the "gauss" ProcessGroup; `split_depth_slabs` runs the
exchange's own packing for g ranks in one process, the all_to_all a
transpose (a rank's work run alone on one card, and tests), and
`fold_stop_bound` bounds the deviation above pixel by pixel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.rasterize_reference import PreprocessedGaussians
from ..ops.rasterize_tiles import render_tiles_raw
from . import collectives as C

# exchange row layout (f32): differentiable screen state first, then the
# integer metadata as exact small values
_R_OPACITY = 5
_R_DEPTH = 9
_R_VALID = 14
N_ROWS = 15
# the largest final T of a walk that stopped early (module docstring)
STOP_T = 1e-4 / (1.0 - 0.99)


def _pre_to_rows(pre: PreprocessedGaussians) -> torch.Tensor:
    """[N_ROWS, n] screen-feature table of a preprocessed set."""
    f32 = torch.float32
    return torch.stack([
        pre.mean2d[:, 0], pre.mean2d[:, 1],
        pre.conic[:, 0], pre.conic[:, 1], pre.conic[:, 2],
        torch.where(pre.valid, pre.opacity, torch.zeros_like(pre.opacity)),
        pre.color[:, 0], pre.color[:, 1], pre.color[:, 2],
        pre.depth,
        pre.rect_min[:, 0].to(f32), pre.rect_min[:, 1].to(f32),
        pre.rect_max[:, 0].to(f32), pre.rect_max[:, 1].to(f32),
        pre.valid.to(f32),
    ], dim=0)


def _rows_to_pre(rows: torch.Tensor) -> PreprocessedGaussians:
    """A PreprocessedGaussians view of a slab table."""
    valid = rows[_R_VALID] > 0.5
    rect_min = torch.stack([rows[10], rows[11]], dim=-1).to(torch.int32)
    rect_max = torch.stack([rows[12], rows[13]], dim=-1).to(torch.int32)
    tiles = ((rect_max[:, 0] - rect_min[:, 0]) * (rect_max[:, 1] - rect_min[:, 1]))
    return PreprocessedGaussians(
        valid=valid,
        mean2d=torch.stack([rows[0], rows[1]], dim=-1),
        conic=torch.stack([rows[2], rows[3], rows[4]], dim=-1),
        opacity=rows[_R_OPACITY],
        color=torch.stack([rows[6], rows[7], rows[8]], dim=-1),
        depth=rows[_R_DEPTH],
        radius=torch.zeros_like(rows[_R_DEPTH]),  # diagnostic, not exchanged
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles, torch.zeros_like(tiles)).to(torch.int32),
    )


def _depth_keys(pre: PreprocessedGaussians) -> torch.Tensor:
    depth = pre.depth.detach()
    return torch.where(pre.valid, depth, torch.full_like(depth, float("inf")))


def default_budget(n_local: int, g: int, slack: float = 4.0) -> int:
    """Per-(source, destination) box of the exchange: the mean n_local / g
    times `slack`, at least 1 and at most n_local."""
    return min(n_local, max(1, -(-int(slack * n_local) // g)))


def _exchange_send(pre: PreprocessedGaussians, keys: torch.Tensor, k: int, g: int,
                   budget: int):
    """Rank k's side of the exchange before the all_to_all. From every
    rank's depth keys [g*n] (in rank order) it finds the slab of each of
    its n gaussians and its offset there, and packs the rows into g send
    boxes of `budget` columns. Returns (send [N_ROWS + 2, g*budget]: the
    screen rows, the slab position and an occupied flag; the gaussians
    past their box, dropped, as a 0-d int32 count)."""
    n = pre.depth.shape[0]
    dev = pre.depth.device
    order = torch.argsort(keys, stable=True)                 # rank -> global index
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(order.shape[0], device=dev)
    my_rank = rank_of[k * n:(k + 1) * n]
    dest = my_rank // n
    pos_in_slab = my_rank - dest * n

    # local gaussians grouped by destination, each group cut at the budget
    rows = _pre_to_rows(pre)                                 # [R, n]
    sortix = torch.argsort(dest, stable=True)
    dsorted = dest[sortix]
    group_start = torch.searchsorted(dsorted, torch.arange(g, device=dev))
    idx_in_group = torch.arange(n, device=dev) - group_start[dsorted]
    keep = idx_in_group < budget
    slot = torch.where(keep, dsorted * budget + idx_in_group,
                       torch.full_like(dsorted, g * budget))
    payload = torch.cat([rows[:, sortix],
                         pos_in_slab[sortix][None].to(torch.float32),  # exact < 2^24
                         torch.ones((1, n), dtype=torch.float32, device=dev)], dim=0)
    send = payload.new_zeros((payload.shape[0], g * budget + 1)).index_copy(1, slot, payload)
    return send[:, :g * budget], (~keep).sum().to(torch.int32)


def _exchange_receive(recv: torch.Tensor, n: int) -> PreprocessedGaussians:
    """The slab of n gaussians from the received boxes [N_ROWS + 2, g*budget]
    (source-rank order): each occupied column scattered to its rank offset."""
    occupied = recv[-1] > 0.5
    slab_pos = torch.where(occupied, recv[-2].long(),
                           torch.full_like(occupied, n, dtype=torch.long))
    got = torch.where(occupied[None], recv[:N_ROWS], torch.zeros_like(recv[:N_ROWS]))
    return _rows_to_pre(got.new_zeros((N_ROWS, n + 1)).index_copy(1, slab_pos, got)[:, :n])


def exchange_by_depth_slab(pre: PreprocessedGaussians, group,
                           budget_per_pair: int | None = None):
    """Re-partition preprocessed gaussians into contiguous depth-rank slabs.

    Rank k of `group` (size g) ends up with the gaussians whose global
    front-to-back rank lies in [k*S, (k+1)*S), S = n_local, each AT its
    rank offset, so a stable local depth sort reproduces the single-device
    order. budget_per_pair bounds each (source, destination) box (default
    `default_budget`); gaussians past it are dropped and counted, never
    indexed out of bounds. Returns (slab_pre, overflow summed over the
    group, a 0-d int32 tensor)."""
    g = dist.get_world_size(group)
    n = pre.depth.shape[0]
    B = int(budget_per_pair if budget_per_pair is not None else default_budget(n, g))
    keys = C.gather_values(_depth_keys(pre), group)          # [P]
    send, overflow = _exchange_send(pre, keys, dist.get_rank(group), g, B)
    # ONE all_to_all of the screen rows (blocks of B gaussians per rank)
    recv = C.all_to_all(send.t(), group).t()                 # [R + 2, g*B]
    return _exchange_receive(recv, n), C.reduce_value(overflow, group)


def split_depth_slabs(pre: PreprocessedGaussians, g: int,
                      budget_per_pair: int | None = None):
    """exchange_by_depth_slab for g ranks in one process: rank k holds rows
    [k*S, (k+1)*S) of `pre` (S = P/g), each rank packs its send boxes as
    the exchange does, and the all_to_all is a transpose of the boxes.
    Returns (the g slabs, the overflow summed over the ranks, a 0-d int32
    tensor). Differentiable in the screen rows."""
    P = pre.depth.shape[0]
    if P % g:
        raise ValueError(f"{P} gaussians do not split into {g} slabs")
    S = P // g
    B = int(budget_per_pair if budget_per_pair is not None else default_budget(S, g))
    keys = _depth_keys(pre)
    sends, overflow = zip(*(_exchange_send(
        PreprocessedGaussians(*(x[k * S:(k + 1) * S] for x in pre)), keys, k, g, B)
        for k in range(g)))
    slabs = [_exchange_receive(torch.cat([s[:, j * B:(j + 1) * B] for s in sends], dim=1), S)
             for j in range(g)]
    return slabs, torch.stack(overflow).sum().to(torch.int32)


def render_slab_band(slab_pre: PreprocessedGaussians, width: int, height: int,
                     band_rows: int, band_start: int, *, max_instances: int,
                     max_chunks_per_tile: int = 64, block: tuple[int, int] = (1, 1),
                     capacity_slack: float = 0.6):
    """Render a depth slab over a band of supertile rows through K1 (K2 in
    backward). Returns (partial [6, band_h, W_padded], binned): rows are
    premultiplied C0 C1 C2, D, A and the differentiable transmittance T,
    what the merge consumes. The depth cotangent is skipped in backward
    (the sharded loss stops the depth gradient, as the reference does)."""
    band, binned, _ = render_tiles_raw(
        slab_pre, width, height, depth_grad=False, max_instances=max_instances,
        max_chunks_per_tile=max_chunks_per_tile, capacity_slack=capacity_slack,
        block_x=block[0], block_y=block[1], contrib_stats=False,
        band_rows=band_rows, band_start=band_start)
    return band[:6], binned


def fold_partials(parts: torch.Tensor) -> torch.Tensor:
    """Front-to-back fold of slab partials [g, 6, h, w] (slab order = depth
    order): C <- C + T * C_k, D and A alike, T <- T * T_k. Returns [6, h, w].
    Differentiable; each slab's cotangent is weighted by its upstream T,
    and T gets the terms of every later slab."""
    C3, D, A, T = parts[0, :3], parts[0, 3], parts[0, 4], parts[0, 5]
    for i in range(1, parts.shape[0]):
        C3 = C3 + T[None] * parts[i, :3]
        D = D + T * parts[i, 3]
        A = A + T * parts[i, 4]
        T = T * parts[i, 5]
    return torch.cat([C3, D[None], A[None], T[None]], dim=0)


def fold_stop_bound(parts: torch.Tensor, t_one: torch.Tensor) -> torch.Tensor:
    """Per pixel [h, w], the transmittance by which fold_partials(parts)
    ([g, 6, h, w] partials) and the one-pass render whose T row is t_one
    may differ: t_one where it is below STOP_T, plus, for each slab whose
    final T is below STOP_T, that T times the T of the slabs in front of
    it. Times the largest splat colour it bounds the C rows (the depth
    for D, 1 for A and T), before rounding."""
    parts = parts.detach()
    t_one = t_one.detach()
    bound = torch.where(t_one < STOP_T, t_one, torch.zeros_like(t_one))
    front = torch.ones_like(t_one)
    for k in range(parts.shape[0]):
        t = parts[k, 5]
        bound = bound + torch.where(t < STOP_T, front * t, torch.zeros_like(t))
        front = front * t
    return bound


def merge_partials(partial: torch.Tensor, group) -> torch.Tensor:
    """The merged composite of every slab of `group`: the partials gathered
    in group-rank (= slab = depth) order and folded. Replicated on every
    rank of the group."""
    return fold_partials(C.all_gather(partial[None], group, dim=0))


def sharded_simi_loss(xyz_shard, scaling_shard, inputs, group, row_offset: int):
    """simi_loss (models/training.simi_loss; gaussian.cu:87-114, 201-239)
    over gauss-SHARDED parameters: the radius (a global mean of the selected
    activated scales) is summed over the group, and each anchor's minimum
    distance is the minimum of the shards' minima, gathered (so the
    gradient reaches the winning shard's xyz and scaling). gauss_idx are
    GLOBAL rows; this shard holds [row_offset, row_offset + n_local)."""
    n_local = xyz_shard.shape[0]
    idx = inputs.gauss_idx.long()
    local = inputs.gauss_mask & (idx >= row_offset) & (idx < row_offset + n_local)
    lidx = torch.clamp(idx - row_offset, 0, n_local - 1)
    xyz = xyz_shard[lidx]
    scales = scaling_shard[lidx]

    sum_scales = C.all_reduce(torch.where(local[:, None], scales, 0.0).sum(), group)
    n_scales = C.reduce_value(local.sum() * 3, group)
    radius = sum_scales / torch.clamp(n_scales, min=1)

    d = torch.linalg.norm(inputs.points[:, None, :] - xyz[None, :, :], dim=-1)
    surf = torch.clamp(d - radius, min=0.0)
    surf = torch.where(local[None, :], surf, float("inf"))
    min_d = C.all_gather(surf.amin(dim=1)[None], group, dim=0).amin(dim=0)
    pmask = inputs.point_mask & torch.isfinite(min_d)
    return torch.where(pmask, min_d, 0.0).sum() / torch.clamp(pmask.sum(), min=1)
