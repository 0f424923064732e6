"""The 3DGS training step: render -> losses -> six-group Adam (port of
gslivm_tpu/models/training.py).

Behavioral spec: reference training thread `optimize_vis`
(src/liw/lioOptimization.cpp:1492-1847) and `Training_setup`
(src/gs/gaussian.cu:396-428):

  - 6 Adam groups (xyz, f_dc, f_rest, scaling, rotation, opacity) with
    feature_rest at feature_lr/20, eps=1e-15, no lr schedule in the live
    path (the optional log-lerp schedule is off by default).
  - per-camera image loss (1-λ)L1 + λ(1-SSIM) (lioOptimization.cpp:1705-1712)
  - structural similarity loss against LiDAR anchor points (calcSimiLoss,
    gaussian.cu:201-239) with MAX_SIMI=500 point cap (gp_types.h:15)
  - delta-depth loss between history camera pairs (calcDeltaSimi,
    gaussian.cu:116-199 + lioOptimization.cpp:1780-1814). With the
    reference's gradient contract (depth grads dropped at the rasterizer,
    rasterizer.cu:79) this term contributes no parameter gradient: its
    inputs are detached and only its value is reported; enable
    RasterizeSettings(depth_grad=True) to make it live.

On the card, the default "auto" backend renders through the tile kernels:
K1 forward with checkpoints, the backward kernel K2, then autograd through
preprocess. The parameters are updated in place by `torch.optim.Adam`;
when the map grows or is pruned in place, `grow_opt_state` and
`compact_opt_state` carry its moments along (the reference's
cat_tensors_to_optimizer and prune_optimizer surgery, gaussian.cu:430-472).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GsOptimParams
from ..ops import losses as loss_ops
from ..ops.rasterize import RasterizeSettings, rasterize
from ..utils import timer
from ..utils.device import resolve_device
from .cameras import Camera
from .gaussian_model import GaussianParams

MAX_SIMI = 500  # gp_types.h:15


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000, lr_delay_steps: float = 0.0):
    """Expon_lr_func (general_utils.cuh:49-83): log-lerped decay with an
    optional sine-delayed warmup. The reference defines it but never
    constructs it in the live path."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0 and step != 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay = 1.0
    t = np.clip(step / max_steps, 0.0, 1.0)
    return float(delay * np.exp(np.log(lr_init) * (1 - t)
                                + np.log(lr_final) * t))


class LossMonitor:
    """Rolling rate-of-change convergence detector (loss_monitor.cu:6-25;
    instantiated nowhere in the reference's live pipeline)."""

    def __init__(self, buffer_size: int = 120):
        self._size = buffer_size
        self._loss: list[float] = []
        self._roc: list[float] = []

    def update(self, new_loss: float) -> float:
        if len(self._loss) >= self._size:
            self._loss.pop(0)
            self._roc.pop(0)
        was_empty = not self._loss
        roc = 0.0 if was_empty else abs(new_loss - self._loss[-1])
        self._roc.append(roc)
        self._loss.append(new_loss)
        return 0.0 if was_empty else sum(self._roc) / len(self._roc)

    def is_converging(self, threshold: float) -> bool:
        if len(self._roc) < self._size:
            return False
        return sum(self._roc) / len(self._roc) <= threshold


# ---------------------------------------------------------------------------
# Optimizer (Training_setup parity)
# ---------------------------------------------------------------------------

_GROUP_LR = {
    "xyz": lambda p: p.position_lr_init * p.spatial_lr_scale,
    "features_dc": lambda p: p.feature_lr,
    "features_rest": lambda p: p.feature_lr / 20.0,
    "scaling": lambda p: p.scaling_lr * p.spatial_lr_scale,
    "rotation": lambda p: p.rotation_lr,
    "opacity": lambda p: p.opacity_lr,
}


def _log_lerp(init: float, final: float, max_steps: int, step: int) -> float:
    """Expon_lr's log-lerped decay at `step` (the delay branch is omitted:
    lr_delay_steps is 0 everywhere in the reference configs)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1.0 - t) + math.log(final) * t)


def _lr_schedule(name: str, p: GsOptimParams):
    """(init, final, max_steps) of a group's log-lerp schedule, or None for
    a constant lr. Only with lr_max_steps > 0, and only xyz and scaling."""
    if p.lr_max_steps <= 0:
        return None
    if name == "xyz" and p.position_lr_final != p.position_lr_init:
        return (p.position_lr_init * p.spatial_lr_scale,
                p.position_lr_final * p.spatial_lr_scale, p.lr_max_steps)
    if name == "scaling" and p.scaling_lr_final != p.scaling_lr:
        return (p.scaling_lr * p.spatial_lr_scale,
                p.scaling_lr_final * p.spatial_lr_scale, p.lr_max_steps)
    return None


def make_optimizer(params: GaussianParams,
                   opt_params: GsOptimParams = GsOptimParams()) -> torch.optim.Adam:
    """One Adam over the six parameter groups, betas (0.9, 0.999) and eps
    1e-15 (gaussian.cu:396-428). Each group carries its `name` and its
    `lr_schedule` (None, or (init, final, max_steps) with lr_max_steps > 0);
    `train_step` sets a scheduled group's lr before each step, so that step
    k uses the schedule's value at k. The n_active buffer is not a
    parameter and is never optimised."""
    groups = [{"params": [getattr(params, name)], "name": name,
               "lr": _GROUP_LR[name](opt_params),
               "lr_schedule": _lr_schedule(name, opt_params)}
              for name in _GROUP_LR]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=opt_params.adam_eps)


def apply_lr_schedule(optimizer: torch.optim.Optimizer):
    """Set each scheduled group's lr for the coming step: the schedule at
    the number of steps the group has taken."""
    for group in optimizer.param_groups:
        sched = group.get("lr_schedule")
        if sched is None:
            continue
        state = optimizer.state.get(group["params"][0], {})
        group["lr"] = _log_lerp(*sched, step=int(state.get("step", 0)))


def _moment_rows(optimizer: torch.optim.Optimizer, rows: int):
    """Every Adam moment (exp_avg, exp_avg_sq) with `rows` leading rows, as
    (state dict, key) pairs; `step` is left alone."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st and st[key].dim() >= 1 and st[key].shape[0] == rows:
                    yield st, key


@torch.no_grad()
def grow_opt_state(optimizer: torch.optim.Optimizer, old_capacity: int,
                   new_capacity: int) -> torch.optim.Optimizer:
    """Zero-pad the Adam moments when the parameters grew in place from
    old_capacity to new_capacity rows (cat_tensors_to_optimizer,
    gaussian.cu:451-472); each group's `step` is kept, as the JAX package
    keeps optax's `count`. A parameter with no state yet (no step taken)
    needs none. Returns the optimizer."""
    pad = new_capacity - old_capacity
    for st, key in list(_moment_rows(optimizer, old_capacity)):
        m = st[key]
        st[key] = torch.cat([m, m.new_zeros((pad,) + tuple(m.shape[1:]))], dim=0)
    return optimizer


@torch.no_grad()
def compact_opt_state(optimizer: torch.optim.Optimizer, order, count) -> torch.optim.Optimizer:
    """Permute the Adam moments with a prune permutation and zero the rows
    past the surviving count, as gaussian_model.compact does to the
    parameters: each gaussian keeps its own moments and freed rows start
    cold like newly appended ones. Returns the optimizer."""
    cap = order.shape[0]
    live = torch.arange(cap, device=order.device) < count
    for st, key in list(_moment_rows(optimizer, cap)):
        m = st[key]
        st[key] = torch.where(live.reshape((-1,) + (1,) * (m.dim() - 1)), m[order], 0.0)
    return optimizer


# ---------------------------------------------------------------------------
# Structural losses
# ---------------------------------------------------------------------------


class SimiInputs(NamedTuple):
    """Fixed-shape inputs to the structural similarity loss.

    points:     [MAX_SIMI, 3] LiDAR anchor points in converged voxels.
    point_mask: [MAX_SIMI] bool.
    gauss_idx:  [MAX_G] int32 indices of gaussians in the matching voxels.
    gauss_mask: [MAX_G] bool.
    """

    points: torch.Tensor
    point_mask: torch.Tensor
    gauss_idx: torch.Tensor
    gauss_mask: torch.Tensor


def simi_loss(params: GaussianParams, inputs: SimiInputs) -> torch.Tensor:
    """calcSimiLoss + compute_min_distance (gaussian.cu:87-114, 201-239).

    Mean over anchor points of the clamped distance to the nearest gaussian
    "sphere" surface; radius = mean of ALL selected activated scales.
    Gradients flow to xyz and scaling only (reference parity). Returns the
    UNSCALED loss (caller multiplies by lambda_depth_simi).
    """
    gmask = inputs.gauss_mask
    idx = torch.where(gmask, inputs.gauss_idx, 0).long()
    xyz = params.xyz[idx]  # [G, 3]
    scales = params.get_scaling()[idx]  # [G, 3]

    n_scales = torch.clamp(gmask.sum() * 3, min=1)
    radius = torch.where(gmask[:, None], scales, 0.0).sum() / n_scales

    # the norm of the differences, not torch.cdist: cdist may take a
    # matrix-product route whose rounding can move the minimum
    d = torch.linalg.norm(inputs.points[:, None, :] - xyz[None, :, :], dim=-1)  # [M, G]
    surf = torch.clamp(d - radius, min=0.0)
    surf = torch.where(gmask[None, :], surf, float("inf"))
    # amin spreads the gradient evenly over ties, as jnp.min does
    min_d = surf.amin(dim=1)
    pmask = inputs.point_mask & torch.isfinite(min_d)
    return (torch.where(pmask, min_d, 0.0).sum()
            / torch.clamp(pmask.sum(), min=1))


def empty_simi(max_points: int = MAX_SIMI, max_gauss: int = 2048,
               device="cuda") -> SimiInputs:
    dev = resolve_device(device)
    return SimiInputs(
        points=torch.zeros((max_points, 3), device=dev),
        point_mask=torch.zeros((max_points,), dtype=torch.bool, device=dev),
        gauss_idx=torch.zeros((max_gauss,), dtype=torch.int32, device=dev),
        gauss_mask=torch.zeros((max_gauss,), dtype=torch.bool, device=dev),
    )


def _delta_warp_fields(depth, cam: Camera, cam_ref: Camera):
    """The ELEMENTWISE part of calcDeltaSimi: backproject cam's rendered
    depth, transform into cam_ref. Returns (depth_ref_frame [H,W],
    gx [H,W], gy [H,W]) — the sample source and normalized sample coords."""
    H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=0).reshape(3, -1)  # [3, HW]

    inv_K = torch.linalg.inv(cam.K)
    cam_pts = inv_K @ (pix * depth.reshape(1, -1))  # [3, HW]

    # cam frame -> world -> ref frame. KNOWN DEVIATION (as in the JAX
    # package): the reference composes T_ref @ inv(T) (gaussian.cu:180),
    # which with its cam->world T matrices inverts the warp direction; this
    # is the geometrically correct inv(T_ref) @ T.
    R_trans = cam_ref.R_cw @ cam.R_cw.T
    t_trans = cam_ref.R_cw @ cam.cam_center + cam_ref.t_cw
    proj = R_trans @ cam_pts + t_trans[:, None]  # [3, HW] in ref frame

    uvw = cam_ref.K @ proj
    u = uvw[0] / uvw[2]
    v = uvw[1] / uvw[2]
    depth_ref_frame = proj[2].reshape(H, W)

    # normalized grid coords, align_corners=True convention
    gx = u / (W - 1) * 2.0 - 1.0
    gy = v / (H - 1) * 2.0 - 1.0
    return depth_ref_frame, gx.reshape(H, W), gy.reshape(H, W)


def _grid_sample_2d(img, gx, gy):
    """Bilinear sampling of img [H, W] at normalized coords (align_corners
    =True, zero padding) that is exactly 0, with a zero gradient, wherever
    the 2x2 footprint lies wholly outside the image — including inf/NaN
    coordinates, which the warp produces at zero-depth (background) pixels.
    Those coordinates are moved far outside (normalized -3) before
    sampling and their result is masked, so no NaN reaches the loss or its
    gradient (the JAX package's safe-where guard)."""
    H, W = img.shape
    x = (gx + 1.0) * 0.5 * (W - 1)
    y = (gy + 1.0) * 0.5 * (H - 1)
    ok = (x > -1.0) & (x < float(W)) & (y > -1.0) & (y < float(H))
    grid = torch.stack([torch.where(ok, gx, -3.0), torch.where(ok, gy, -3.0)], dim=-1)
    res = F.grid_sample(img[None, None], grid[None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)[0, 0]
    return torch.where(ok, res, 0.0)


def delta_depth_warp(depth, cam: Camera, cam_ref: Camera):
    """calcDeltaSimi (gaussian.cu:116-199): backproject cam's rendered depth,
    transform into cam_ref, and bilinearly sample the warped-depth image at
    the reprojected pixel grid (align_corners=True, zero padding)."""
    depth_ref_frame, gx, gy = _delta_warp_fields(depth, cam, cam_ref)
    return _grid_sample_2d(depth_ref_frame, gx, gy)


def delta_depth_loss(depth_a, acc_a, cam_a: Camera,
                     depth_b, acc_b, cam_b: Camera) -> torch.Tensor:
    """lioOptimization.cpp:1780-1799: inverse-depth gap between the warped
    rendered depth and the reference rendered depth, masked by both
    silhouettes. Returns the UNSCALED mean gap."""
    warped = delta_depth_warp(depth_a, cam_a, cam_b)
    inv_w = loss_ops.inv_depth(warped)
    inv_ref = loss_ops.inv_depth(depth_b)
    mask = ((acc_a >= 0.5) & (acc_b >= 0.5)).to(depth_a.dtype)
    return torch.abs(inv_w * mask - inv_ref * mask).mean()


def delta_depth_band_sum(depth_a, acc_a, cam_a: Camera,
                         depth_b, acc_b, cam_b: Camera,
                         row_lo: int, n_rows: int) -> torch.Tensor:
    """SUM of the delta-depth gap over output rows [row_lo, row_lo+n_rows).

    The pixel-sharded delta loss building block: the warp's backproject and
    transform stay full-frame (they are the sample source for arbitrary
    reprojected coordinates), the bilinear sampling and the reduction run
    on the band; the full-image mean is the sum of the band sums over H*W.
    Rows at or beyond H contribute nothing."""
    H = depth_a.shape[0]
    drf, gx, gy = _delta_warp_fields(depth_a, cam_a, cam_b)
    lo = min(max(int(row_lo), 0), H)
    band = slice(lo, lo + n_rows)
    warped = _grid_sample_2d(drf, gx[band], gy[band])
    inv_w = loss_ops.inv_depth(warped)
    inv_ref = loss_ops.inv_depth(depth_b[band])
    mask = ((acc_a[band] >= 0.5) & (acc_b[band] >= 0.5)).to(depth_a.dtype)
    return torch.abs(inv_w * mask - inv_ref * mask).sum()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


class TrainMetrics(NamedTuple):
    """One step's metrics, as 0-d tensors on the parameters' device."""

    loss: torch.Tensor
    image_loss: torch.Tensor
    simi: torch.Tensor
    delta: torch.Tensor
    psnr: torch.Tensor
    ssim: torch.Tensor
    # max binning overflow across this step's renders: > 0 means the tile
    # budgets truncated instances (images and gradients approximate)
    overflow: torch.Tensor
    # budget feedback (max over this step's renders): the true instance
    # expansion, the busiest tile's chunk count and the walked-chunk total
    num_instances: torch.Tensor
    max_nchunks: torch.Tensor
    walked_chunks: torch.Tensor


def render_params(params: GaussianParams, camera: Camera, bg_color,
                  settings: RasterizeSettings):
    """render() equivalent (render_utils.cuh:13-56): activations + rasterize.

    With the default "auto" backend a map on the card renders through the
    tile kernels, differentiably; serving calls it under torch.no_grad().
    """
    return rasterize(
        params.xyz,
        params.get_scaling(),
        params.get_rotation(),
        params.get_opacity(),
        params.get_features(),
        camera,
        bg_color=bg_color,
        settings=settings,
        active_mask=params.active_mask(),
    )


def train_step(
    params: GaussianParams,
    optimizer: torch.optim.Optimizer,
    cameras: Sequence[Camera],
    gt_images,  # [n_cams, 3, H, W]
    simi: SimiInputs,
    opt_params: GsOptimParams = GsOptimParams(),
    settings: RasterizeSettings = RasterizeSettings(),
    n_history_pairs: int = 0,
    bg_color=None,
    gt_stats=None,
) -> TrainMetrics:
    """One optimize_vis iteration (lioOptimization.cpp:1660-1846).

    Updates `params` IN PLACE through `optimizer` (from `make_optimizer`),
    the port's counterpart of the JAX package's `train_step_donating`: the
    parameter and Adam-state buffers are reused, as the reference mutates
    its tensors. After the call each parameter's `.grad` holds this step's
    gradient. Returns the step's metrics as device tensors (reading them
    waits for the card).

    cameras: the LAST 2*n_history_pairs cameras form delta-depth pairs
    (i, i+1), mirroring the history sampling of lioOptimization.cpp:1780.
    gt_stats: optional (mu2 [n,3,H,W], sigma2_sq [n,3,H,W]), the GT-side
    SSIM statistics from losses.ssim_ref_stats, cached per keyframe.
    """
    dev = params.xyz.device
    if bg_color is None:
        bg_color = torch.ones(3, dtype=torch.float32, device=dev)  # white_background
    # the train step never consumes per-pixel n_contrib: drop its forward
    # bookkeeping, as the JAX step does
    settings = settings._replace(contrib_stats=False)

    def as_int(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    optimizer.zero_grad(set_to_none=True)
    img_losses, renders = [], []
    overflow = n_inst = n_chunks = n_walked = as_int(0)
    psnr0 = ssim0 = None
    for i, cam in enumerate(cameras):
        with timer.span("step.render"):
            out = render_params(params, cam, bg_color, settings)
            renders.append(out)
            overflow = torch.maximum(overflow, as_int(out.overflow))
            n_inst = torch.maximum(n_inst, as_int(out.num_instances))
            n_chunks = torch.maximum(n_chunks, as_int(out.max_nchunks))
            n_walked = torch.maximum(n_walked, as_int(out.walked_chunks))
        with timer.span("step.loss"):
            l1 = loss_ops.l1_loss(out.color, gt_images[i])
            rs = None if gt_stats is None else (gt_stats[0][i], gt_stats[1][i])
            ss = loss_ops.ssim(out.color, gt_images[i], ref_stats=rs)
            img_losses.append((1.0 - opt_params.lambda_dssim) * l1
                              + opt_params.lambda_dssim * (1.0 - ss))
            if i == 0:
                with torch.no_grad():
                    psnr0 = loss_ops.psnr(out.color, gt_images[i])
                ssim0 = ss.detach()

    # Under the reference gradient contract (depth cotangents dropped at the
    # rasterizer, rasterizer.cu:79; the silhouette mask enters only through
    # comparisons) the delta-depth term has IDENTICALLY ZERO parameter
    # gradient: detach its inputs and build no warp backward (the value is
    # still reported). With depth_grad=True the term is live.
    def sg(x):
        return x if settings.depth_grad else x.detach()

    with timer.span("step.loss"):
        image_total = sum(img_losses)
        s_loss = opt_params.lambda_depth_simi * simi_loss(params, simi)
        d_loss = torch.zeros((), device=dev)
        n = len(cameras)
        for k in range(n_history_pairs):
            ia = n - 2 * n_history_pairs + 2 * k
            ib = ia + 1
            d_loss = d_loss + opt_params.lambda_delta_depth_simi * delta_depth_loss(
                sg(renders[ia].depth), sg(renders[ia].acc), cameras[ia],
                sg(renders[ib].depth), sg(renders[ib].acc), cameras[ib])
        total = image_total + s_loss + d_loss
    with timer.span("step.backward"):
        total.backward()
    with timer.span("step.adam"):
        apply_lr_schedule(optimizer)
        optimizer.step()
    return TrainMetrics(
        loss=total.detach(), image_loss=image_total.detach(),
        simi=s_loss.detach(), delta=d_loss.detach(), psnr=psnr0, ssim=ssim0,
        overflow=overflow, num_instances=n_inst, max_nchunks=n_chunks,
        walked_chunks=n_walked)
