"""Sharded rendering and training over a ("gauss", "pixel") mesh of ranks
(port of gslivm_tpu/parallel/sharding.py onto torch.distributed).

  - "pixel" axis, data parallelism over the image: each rank composites a
    band of pixel rows, and the bands are all_gathered into the frame; the
    losses then reduce each rank's band only (L1, SSIM with its halo rows,
    the delta-depth sampling) and sum the band sums over the axis.
  - "gauss" axis, model parallelism over the map's capacity rows. Each rank
    holds its shard of the parameters and its own six-group Adam over it.
      renderer "oracle" / "tiles": the shards are all_gathered for compute
        (the gather's backward is a reduce-scatter of the gradients).
        "oracle" composites a chunk of flat pixels with the naive math (the
        CPU verification path); "tiles" renders the rank's band through the
        tile kernels K1/K2 (the JAX package calls it "pallas").
      renderer "primitive": no parameter gather; each rank preprocesses its
        shard, one all_to_all moves the screen rows into depth-rank slabs,
        each rank renders its slab over its band through K1/K2 and the
        partials are merged in depth order (primitive.py).

The rank layout is row-major, rank = gauss_index * n_pixel + pixel_index,
as the JAX mesh's device array. Collectives run on gloo for CPU tensors
and on NCCL for CUDA tensors; the step refuses a shard whose device does
not match the group's backend. Gradients follow collectives.py's
convention: every rank of the mesh backpropagates loss / (the mesh's
ranks), and the shard's gradient is summed over the pixel axis, which
holds copies of it.
"""

from __future__ import annotations

import datetime
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from ..config import GsOptimParams
from ..models import training
from ..models.cameras import Camera
from ..models.gaussian_model import GaussianParams
from ..ops import losses as loss_ops
from ..ops.rasterize_reference import (
    TILE,
    PreprocessedGaussians,
    _composite_pixels,
    depth_order,
    preprocess,
    tile_grid,
)
from ..ops.rasterize_tiles import rasterize_tiles
from . import collectives as C
from . import primitive

AXES = ("gauss", "pixel")
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}
RENDERERS = ("oracle", "tiles", "primitive")
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
_ORACLE_PIXEL_CHUNK = 4096


def init_process_group(device, rank: int, world: int, init_method: str,
                       timeout_s: float = 300.0):
    """torch.distributed's default group for `device`'s tensors: gloo for the
    CPU, NCCL for CUDA (never the other). A rendezvous that does not
    complete within timeout_s raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(world: int | None = None, gauss_axis: int | None = None):
    """The ("gauss", "pixel") DeviceMesh of the default group's first
    `world` ranks (all by default), row-major; by default 2 gauss rows when
    the mesh is even and >= 4 ranks. Every rank of the default group calls
    it; a rank past `world` holds no coordinate in the mesh and takes no
    part in its steps."""
    from torch.distributed.device_mesh import DeviceMesh  # noqa: PLC0415

    total = dist.get_world_size()
    world = total if world is None else world
    if not 0 < world <= total:
        raise ValueError(f"a mesh of {world} ranks in a world of {total}")
    if gauss_axis is None:
        gauss_axis = 2 if world % 2 == 0 and world >= 4 else 1
    if world % gauss_axis:
        raise ValueError(f"gauss axis {gauss_axis} does not divide world {world}")
    device_type = {v: k for k, v in BACKENDS.items()}[dist.get_backend()]
    return DeviceMesh(device_type, torch.arange(world).reshape(gauss_axis, world // gauss_axis),
                      mesh_dim_names=AXES)


class _Axis(NamedTuple):
    group: object
    size: int
    index: int


def mesh_axis(mesh, name: str) -> _Axis:
    """(group, size, this rank's index) of a mesh axis."""
    return _Axis(mesh.get_group(name), mesh.size(AXES.index(name)),
                 mesh.get_local_rank(name))


class GaussianShard(GaussianParams):
    """A rank's rows [row_offset, row_offset + capacity) of a capacity-padded
    map. `n_active` is the map's global count, so the live rows are those
    whose GLOBAL index is below it: the single-device contract. (The JAX
    step compares local indices with the global count on every shard.)"""

    def __init__(self, *fields, n_active, row_offset: int):
        super().__init__(*fields, n_active=n_active)
        self.row_offset = int(row_offset)

    def active_mask(self):
        return (self.row_offset + torch.arange(self.capacity, device=self.xyz.device)
                < self.n_active)


def shard_params(params: GaussianParams, mesh) -> GaussianShard:
    """This rank's gauss shard of `params` (copies of its rows; capacity
    divisible by the gauss axis)."""
    gauss = mesh_axis(mesh, "gauss")
    cap = params.capacity
    if cap % gauss.size:
        raise ValueError(f"capacity {cap} does not split over {gauss.size} shards")
    n = cap // gauss.size
    rows = slice(gauss.index * n, (gauss.index + 1) * n)
    with torch.no_grad():
        fields = [getattr(params, f)[rows].clone() for f in FIELDS]
    return GaussianShard(*fields, n_active=int(params.n_active),
                         row_offset=gauss.index * n)


class _Fields:
    """Parameter tensors outside a module (the gathered map), with the
    activations of GaussianParams."""

    capacity = GaussianParams.capacity
    sh_degree = GaussianParams.sh_degree
    active_mask = GaussianParams.active_mask
    get_scaling = GaussianParams.get_scaling
    get_rotation = GaussianParams.get_rotation
    get_opacity = GaussianParams.get_opacity
    get_features = GaussianParams.get_features

    def __init__(self, n_active, **fields):
        self.__dict__.update(fields)
        self.n_active = n_active


def gather_params(shard: GaussianShard, group) -> _Fields:
    """The whole map from the gauss shards (all_gather; differentiable)."""
    return _Fields(shard.n_active, **{f: C.all_gather(getattr(shard, f), group)
                                      for f in FIELDS})


def _preprocess(p, cam: Camera) -> PreprocessedGaussians:
    return preprocess(p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity()[:, 0],
                      p.get_features(), cam, sh_degree=p.sh_degree,
                      active_mask=p.active_mask())


def band_rows_for(cam: Camera, n_pixel: int, block: tuple[int, int]) -> int:
    """Supertile rows of each pixel rank's band."""
    sgrid_y = -(-tile_grid(cam.width, cam.height)[1] // block[1])
    return -(-sgrid_y // n_pixel)


class _View(NamedTuple):
    color: torch.Tensor
    depth: torch.Tensor
    acc: torch.Tensor
    overflow: torch.Tensor       # 0-d int32, summed over the ranks' renders
    num_instances: torch.Tensor  # 0-d int32, the camera's instances, all ranks
    max_nchunks: torch.Tensor
    walked_chunks: torch.Tensor


def _render_pixels_chunk(p, cam: Camera, bg_color, lo: int, n: int):
    """Naive composite of flat pixels [lo, lo + n): [n, 5] rows (RGB, D, A)."""
    pre = _preprocess(p, cam)
    order = depth_order(pre)[:max(int(pre.valid.sum()), 1)]
    pre_sorted = PreprocessedGaussians(*(x[order] for x in pre))
    W = cam.width
    out = []
    for s in range(lo, lo + n, _ORACLE_PIXEL_CHUNK):
        idx = torch.arange(s, min(s + _ORACLE_PIXEL_CHUNK, lo + n), device=p.xyz.device)
        pix_xy = torch.stack([(idx % W).to(torch.float32),
                              (idx // W).to(torch.float32)], dim=-1)
        tile_xy = torch.div(pix_xy, TILE, rounding_mode="floor").to(torch.int32)
        color, depth, acc, _, _ = _composite_pixels(pix_xy, tile_xy, pre_sorted, bg_color)
        out.append(torch.cat([color, depth[:, None], acc[:, None]], dim=1))
    return torch.cat(out, dim=0), pre.tiles_touched.sum()


def _render_view(gathered, shard: GaussianShard, cam: Camera, bg_color, renderer: str,
                 gauss: _Axis, pixel: _Axis, max_instances: int,
                 block: tuple[int, int], exchange_slack: float) -> _View:
    """One camera's full (replicated) colour/depth/acc under the renderer."""
    H, W = cam.height, cam.width
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=shard.xyz.device)
    if renderer == "oracle":
        n_pix = H * W
        chunk = -(-n_pix // pixel.size)
        rows, touched = _render_pixels_chunk(gathered, cam, bg_color,
                                             pixel.index * chunk, chunk)
        full = C.all_gather(rows, pixel.group)[:n_pix]
        return _View(full[:, :3].reshape(H, W, 3).permute(2, 0, 1),
                     full[:, 3].reshape(H, W), full[:, 4].reshape(H, W), zero,
                     touched.to(i32), zero, zero)
    band_rows = band_rows_for(cam, pixel.size, block)
    band_start = pixel.index * band_rows
    if renderer == "tiles":
        p = gathered
        out = rasterize_tiles(
            p.xyz, p.get_scaling(), p.get_rotation(), p.get_opacity()[:, 0],
            p.get_features(), cam, bg_color=bg_color, sh_degree=p.sh_degree,
            active_mask=p.active_mask(), max_instances=max_instances,
            block_x=block[0], block_y=block[1], depth_grad=False, contrib_stats=False,
            band_rows=band_rows, band_start=band_start)
        rows = torch.cat([out.color, out.depth[None], out.acc[None]], dim=0)
        full = C.all_gather(rows, pixel.group, dim=1)
        counts = torch.stack([out.overflow, out.num_instances, out.walked_chunks]).to(i32)
        counts = C.reduce_value(counts, pixel.group)
        nch = C.reduce_value(out.max_nchunks.to(i32), pixel.group, dist.ReduceOp.MAX)
        return _View(full[:3, :H], full[3, :H], full[4, :H], counts[0], counts[1], nch,
                     counts[2])
    if renderer != "primitive":
        raise ValueError(f"unknown renderer {renderer!r}; one of {RENDERERS}")
    pre = _preprocess(shard, cam)
    budget = primitive.default_budget(pre.depth.shape[0], gauss.size, exchange_slack)
    slab, ovf_ex = primitive.exchange_by_depth_slab(pre, gauss.group, budget)
    partial, binned = primitive.render_slab_band(
        slab, W, H, band_rows, band_start, max_instances=max_instances, block=block)
    merged = primitive.merge_partials(partial, gauss.group)
    full = C.all_gather(merged, pixel.group, dim=1)
    color = (full[:3] + full[5][None] * bg_color[:, None, None])[:, :H, :W]
    counts = torch.stack([binned.overflow, binned.num_instances]).to(i32)
    counts = C.reduce_value(C.reduce_value(counts, pixel.group), gauss.group)
    nch = C.reduce_value(C.reduce_value(binned.tile_nchunks.max().to(i32), pixel.group,
                                        dist.ReduceOp.MAX), gauss.group, dist.ReduceOp.MAX)
    return _View(color, full[3, :H, :W], full[4, :H, :W], ovf_ex + counts[0], counts[1],
                 nch, zero)


def sharded_loss_fn(shard: GaussianShard, mesh, cameras: Sequence[Camera], gt_images,
                    simi: training.SimiInputs, bg_color,
                    opt_params: GsOptimParams = GsOptimParams(), renderer: str = "oracle",
                    max_instances: int = 2**18, block: tuple[int, int] = (1, 1),
                    n_history_pairs: int = 0, exchange_slack: float = 4.0):
    """This rank's copy of the replicated loss and its metrics.

    Parity with models.training.train_step: per camera (1-λ)·L1 + λ·(1-SSIM)
    (each a sum of pixel-band sums over the "pixel" axis, divided by
    3*H*W), simi, and delta-depth over the LAST 2*n_history_pairs cameras
    (depth and silhouette carry no gradient: the reference's depth-grad-drop
    contract, rasterizer.cu:79). Returns (total, TrainMetrics); total is
    equal on every rank and differentiable in the shard."""
    gauss, pixel = mesh_axis(mesh, "gauss"), mesh_axis(mesh, "pixel")
    gathered = None if renderer == "primitive" else gather_params(shard, gauss.group)
    i32 = torch.int32
    image_total = torch.zeros((), device=shard.xyz.device)
    overflow = n_inst = n_chunks = n_walked = torch.zeros((), dtype=i32,
                                                          device=shard.xyz.device)
    psnr0 = ssim0 = None
    views = []
    for i, cam in enumerate(cameras):
        v = _render_view(gathered, shard, cam, bg_color, renderer, gauss, pixel,
                         max_instances, block, exchange_slack)
        views.append(v)
        overflow = torch.maximum(overflow, v.overflow)
        n_inst = torch.maximum(n_inst, v.num_instances)
        n_chunks = torch.maximum(n_chunks, v.max_nchunks)
        n_walked = torch.maximum(n_walked, v.walked_chunks)
        H, W = cam.height, cam.width
        band_n = -(-H // pixel.size)
        band_lo = pixel.index * band_n
        norm = v.color.shape[0] * H * W
        l1 = C.all_reduce(loss_ops.l1_band_sum(v.color, gt_images[i], band_lo, band_n),
                          pixel.group) / norm
        ss = C.all_reduce(loss_ops.ssim_band_sum(v.color, gt_images[i], band_lo, band_n),
                          pixel.group) / norm
        image_total = image_total + ((1.0 - opt_params.lambda_dssim) * l1
                                     + opt_params.lambda_dssim * (1.0 - ss))
        if i == 0:
            with torch.no_grad():
                psnr0 = loss_ops.psnr(v.color, gt_images[i])
            ssim0 = ss.detach()

    if renderer == "primitive":
        simi_raw = primitive.sharded_simi_loss(shard.xyz, shard.get_scaling(), simi,
                                               gauss.group, shard.row_offset)
    else:
        simi_raw = training.simi_loss(gathered, simi)
    s_loss = opt_params.lambda_depth_simi * simi_raw

    d_loss = torch.zeros((), device=shard.xyz.device)
    n = len(cameras)
    for k in range(n_history_pairs):
        ia = n - 2 * n_history_pairs + 2 * k
        ib = ia + 1
        H, W = cameras[ia].height, cameras[ia].width
        band_n = -(-H // pixel.size)
        a, b = views[ia], views[ib]
        band_sum = training.delta_depth_band_sum(
            a.depth.detach(), a.acc.detach(), cameras[ia],
            b.depth.detach(), b.acc.detach(), cameras[ib],
            pixel.index * band_n, band_n)
        d_loss = d_loss + opt_params.lambda_delta_depth_simi * C.reduce_value(
            band_sum, pixel.group) / (H * W)

    total = image_total + s_loss + d_loss
    metrics = training.TrainMetrics(
        loss=total.detach(), image_loss=image_total.detach(), simi=s_loss.detach(),
        delta=d_loss, psnr=psnr0, ssim=ssim0, overflow=overflow, num_instances=n_inst,
        max_nchunks=n_chunks, walked_chunks=n_walked)
    return total, metrics


def sharded_train_step(
    mesh,
    shard: GaussianShard,
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],
    gt_images,
    simi: training.SimiInputs,
    opt_params: GsOptimParams = GsOptimParams(),
    bg_color=None,
    renderer: str = "oracle",
    max_instances: int = 2**18,
    block: tuple[int, int] = (1, 1),
    n_history_pairs: int = 0,
    exchange_slack: float = 4.0,
) -> training.TrainMetrics:
    """One training step with a gauss-sharded map and pixel-sharded renders.

    Every rank of `mesh` calls it with its shard (shard_params) and its own
    `training.make_optimizer(shard, opt_params)`; cameras, gt_images [n, 3,
    H, W], simi (GLOBAL gaussian rows) and bg_color are the same on every
    rank. The LAST 2*n_history_pairs cameras form delta-depth pairs, as in
    training.train_step. Renderers: "oracle", "tiles" (the JAX package's
    "pallas") and "primitive".

    Updates the shard IN PLACE through the optimizer, leaves the shard's
    gradient of the total loss in each parameter's `.grad` (the same on
    every rank of the pixel axis), and returns the TrainMetrics, equal on
    every rank. overflow counts instances dropped by the tile budgets and
    gaussians dropped by the exchange's boxes."""
    dev = shard.xyz.device
    if BACKENDS[dev.type] != dist.get_backend():
        raise ValueError(f"{dev.type} tensors need the {BACKENDS[dev.type]} backend, "
                         f"not {dist.get_backend()}")
    if bg_color is None:
        bg_color = torch.ones(3, dtype=torch.float32, device=dev)
    optimizer.zero_grad(set_to_none=True)
    total, metrics = sharded_loss_fn(
        shard, mesh, cameras, gt_images, simi, bg_color, opt_params, renderer=renderer,
        max_instances=max_instances, block=block, n_history_pairs=n_history_pairs,
        exchange_slack=exchange_slack)
    (total / mesh.size()).backward()
    pixel = mesh_axis(mesh, "pixel")
    for f in FIELDS:
        t = getattr(shard, f)
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        dist.all_reduce(t.grad, group=pixel.group)
    training.apply_lr_schedule(optimizer)
    optimizer.step()
    return metrics
