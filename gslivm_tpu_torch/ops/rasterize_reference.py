"""Naive differentiable rasterizer — the correctness oracle and CPU backend
(port of gslivm_tpu/ops/rasterize_reference.py).

A direct O(P * pixels) implementation of the reference CUDA rasterizer
semantics (`src/cuda_rasterizer/forward.cu`, `rasterizer_impl.cu`).
Gradients come from torch autograd of the exact forward math.

Parity quirks reproduced deliberately:
  - near cull at z <= 0.2 (forward.cu:223-225)
  - oversize-scale cull s*mod > 0.3 (forward.cu:19-25, 227)
  - unnormalized quaternion in cov3D (forward.cu:146)
  - +0.3 pixel low-pass on cov2D (forward.cu:130-131)
  - sqrt(max(0.1, ...)) eigenvalue clamp for the radius (forward.cu:261-262)
  - 1/(w + 1e-7) projection guard (forward.cu:233)
  - 16x16 tile-rect membership: a pixel only sees gaussians whose tile rect
    covers the pixel's tile (getRect, auxiliary.h:39-45)
  - alpha = min(0.99, o*exp(power)), skip power>0, skip alpha<1/255,
    stop when T*(1-alpha) < 1e-4 (forward.cu:357-394)
  - depth-sorted front-to-back with ties broken by gaussian index
    (rasterizer_impl.cu:94, 295-309)
  - output color = C + T_final * bg (forward.cu:402-403); depth/acc get no
    background term
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import covariance as cov_ops
from . import sh as sh_ops
from ..models.cameras import Camera

TILE = 16  # config.h:16-17 (BLOCK_X = BLOCK_Y = 16)


class PreprocessedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (the CUDA preprocess outputs)."""

    valid: torch.Tensor  # [N] bool — survives all culls
    mean2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N]
    color: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N] view-space z
    radius: torch.Tensor  # [N] pixel radius (0 for culled)
    rect_min: torch.Tensor  # [N, 2] int32 tile coords (x, y)
    rect_max: torch.Tensor  # [N, 2] int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # [N] int32


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def get_rect(mean2d, radius_xy, grid_x: int, grid_y: int):
    """auxiliary.h:39-45 — trunc-toward-zero then clamp to [0, grid].

    radius_xy: [..., 2] per-axis half-extents in pixels.
    """
    lo = torch.trunc((mean2d - radius_xy) / TILE)
    hi = torch.trunc((mean2d + radius_xy + TILE - 1) / TILE)
    # filled on the device (no copy from the host, which a captured step
    # cannot make)
    limits = torch.full((2,), grid_x, dtype=torch.int32, device=mean2d.device)
    limits[1:].fill_(grid_y)
    zero = torch.zeros_like(limits)
    rect_min = torch.clamp(lo.to(torch.int32), zero, limits)
    rect_max = torch.clamp(hi.to(torch.int32), zero, limits)
    return rect_min, rect_max


def tile_min_power(mx, my, ca, cb, cc, tile_x, tile_y, pw: int = TILE,
                   ph: int = TILE, rb_a=None, rb_c=None):
    """Exact minimum of q(d) = 0.5(a dx² + c dy²) + b dx dy over a tile's
    pixel box [pw·tx, pw·tx+pw−1] × [ph·ty, ph·ty+ph−1].

    q = -power of the splat kernel (forward.cu:355), so a tile with
    opacity·exp(-q_min) < 1/255 holds NO pixel that passes the render
    kernel's alpha test (forward.cu:374). rb_a/rb_c = -cb / max(ca, 1e-12),
    -cb / max(cc, 1e-12) may be precomputed per gaussian. All args
    broadcast.
    """
    x0 = tile_x * pw - mx
    x1 = x0 + (pw - 1)
    y0 = tile_y * ph - my
    y1 = y0 + (ph - 1)
    inside = (x0 <= 0) & (0 <= x1) & (y0 <= 0) & (0 <= y1)
    if rb_a is None:
        rb_a = -cb / torch.clamp(ca, min=1e-12)
    if rb_c is None:
        rb_c = -cb / torch.clamp(cc, min=1e-12)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    # min over each of the 4 box edges: 1-D quadratic, stationary point
    # clamped into the edge segment
    qy0 = q(x0, torch.clamp(x0 * rb_c, y0, y1))
    qy1 = q(x1, torch.clamp(x1 * rb_c, y0, y1))
    qx0 = q(torch.clamp(y0 * rb_a, x0, x1), y0)
    qx1 = q(torch.clamp(y1 * rb_a, x0, x1), y1)
    qmin = torch.minimum(torch.minimum(qy0, qy1), torch.minimum(qx0, qx1))
    return torch.where(inside, torch.zeros_like(qmin), torch.clamp(qmin, min=0.0))


# keep-threshold for the tile cull: alpha >= 1/255 with a small conservative
# margin so f32 rounding differences between the cull's bound and the render
# kernel's own alpha evaluation can never drop a passing pixel
TILE_CULL_EPS = 1.0 / 255.0 * (1.0 - 1e-5)


def tile_accepts(mx, my, ca, cb, cc, opacity, tile_x, tile_y):
    """True if any pixel of the tile can pass the alpha >= 1/255 test."""
    qmin = tile_min_power(mx, my, ca, cb, cc, tile_x, tile_y)
    return opacity * torch.exp(-qmin) >= TILE_CULL_EPS


def preprocess(
    means,
    scales,
    quats,
    opacities,
    shs,
    camera: Camera,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    active_mask=None,
) -> PreprocessedGaussians:
    """preprocessCUDA (forward.cu:180-286), vectorized.

    `active_mask` supports capacity-padded parameter buffers: padded slots
    behave exactly like culled gaussians.
    """
    grid_x, grid_y = tile_grid(camera.width, camera.height)

    p_view = means @ camera.R_cw.T + camera.t_cw
    z = p_view[..., 2]
    near_ok = z > 0.2

    size_ok = ~cov_ops.scale_abnormal(scales, scale_modifier)

    # z + 1e-7 can be ~0 for culled slots; substitute a safe depth there so
    # the projection stays finite
    z_div = torch.where(near_ok, z, torch.ones_like(z))
    w_inv = 1.0 / (z_div + 1e-7)
    ndc_x = (p_view[..., 0] / camera.tan_fovx) * w_inv
    ndc_y = (p_view[..., 1] / camera.tan_fovy) * w_inv
    pix_x = ((ndc_x + 1.0) * camera.width - 1.0) * 0.5
    pix_y = ((ndc_y + 1.0) * camera.height - 1.0) * 0.5
    mean2d = torch.stack([pix_x, pix_y], dim=-1)

    cov3d = cov_ops.compute_cov3d(scales, quats, scale_modifier)
    p_view_safe = torch.stack([p_view[..., 0], p_view[..., 1], z_div], dim=-1)
    cov2d = cov_ops.compute_cov2d(
        p_view_safe, cov3d, camera.R_cw, camera.fx, camera.fy,
        camera.tan_fovx, camera.tan_fovy)
    conic, radius, det = cov_ops.conic_and_radius(cov2d)
    det_ok = det != 0.0

    # Tight lossless binning rect: the render kernel only composites pixels
    # with alpha >= 1/255, i.e. inside the Mahalanobis ellipse of radius
    # r* = sqrt(2 ln(255 op)); its axis-aligned hull has half-extents
    # min(radius, r* sqrt(Sigma_ii)) (see the JAX module for the derivation).
    op = opacities.reshape(opacities.shape[0])
    rstar = torch.sqrt(torch.clamp(
        2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)), min=0.0)) * (1.0 + 1e-5)
    hx = torch.minimum(radius, rstar * torch.sqrt(torch.clamp(cov2d[..., 0], min=0.0)))
    hy = torch.minimum(radius, rstar * torch.sqrt(torch.clamp(cov2d[..., 2], min=0.0)))
    half_extents = torch.stack([hx, hy], dim=-1).detach()

    rect_min, rect_max = get_rect(mean2d, half_extents, grid_x, grid_y)
    tiles = (rect_max[..., 0] - rect_min[..., 0]) * (rect_max[..., 1] - rect_min[..., 1])
    rect_ok = tiles > 0

    valid = near_ok & size_ok & det_ok & rect_ok
    if active_mask is not None:
        valid = valid & active_mask

    color = sh_ops.sh_to_color(shs, means, camera.cam_center, sh_degree)

    return PreprocessedGaussians(
        valid=valid,
        mean2d=mean2d,
        conic=conic,
        opacity=op,
        color=color,
        depth=z,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles, torch.zeros_like(tiles)).to(torch.int32),
    )


def depth_order(pre: PreprocessedGaussians):
    """Front-to-back order with index tie-break (stable sort; invalid last)."""
    key = torch.where(pre.valid, pre.depth.detach(),
                      torch.full_like(pre.depth, float("inf")))
    return torch.argsort(key, stable=True)


def _composite_pixels(pix_xy, tile_xy, pre_sorted, bg_color):
    """Alpha-composite all sorted gaussians onto a block of pixels.

    pix_xy: [B, 2] float pixel coords; tile_xy: [B, 2] int tile coords.
    Returns (color [B,3], depth [B], acc [B], final_T [B], n_contrib [B]).
    """
    d = pix_xy[:, None, :] - pre_sorted.mean2d[None, :, :]  # [B, N, 2]
    a = pre_sorted.conic[None, :, 0]
    b = pre_sorted.conic[None, :, 1]
    c = pre_sorted.conic[None, :, 2]
    power = (
        -0.5 * (a * d[..., 0] * d[..., 0] + c * d[..., 1] * d[..., 1])
        - b * d[..., 0] * d[..., 1]
    )  # [B, N]

    in_rect = torch.all(
        (tile_xy[:, None, :] >= pre_sorted.rect_min[None])
        & (tile_xy[:, None, :] < pre_sorted.rect_max[None]),
        dim=-1,
    )  # [B, N]

    alpha = torch.clamp(pre_sorted.opacity[None, :] * torch.exp(power), max=0.99)
    accepted = (
        pre_sorted.valid[None, :] & in_rect & (power <= 0.0) & (alpha >= 1.0 / 255.0)
    )
    alpha_eff = torch.where(accepted, alpha, torch.zeros_like(alpha))

    # transmittance BEFORE each gaussian: exclusive cumprod of (1 - alpha)
    one_minus = 1.0 - alpha_eff
    T_prev = torch.cat(
        [torch.ones_like(alpha_eff[:, :1]), torch.cumprod(one_minus, dim=1)[:, :-1]],
        dim=1,
    )

    # early stop: the first accepted gaussian with T*(1-alpha) < 1e-4 sets
    # "done"; it and everything after contribute nothing (forward.cu:377-381)
    would_stop = accepted & (T_prev * (1.0 - alpha) < 1e-4)
    done = torch.cumsum(would_stop.to(torch.int32), dim=1) > 0
    contrib = accepted & ~done

    w = torch.where(contrib, alpha_eff * T_prev, torch.zeros_like(alpha_eff))
    color = w @ pre_sorted.color  # [B, 3]
    depth = (w * pre_sorted.depth[None, :]).sum(dim=1)
    acc = w.sum(dim=1)
    final_T = torch.where(contrib, one_minus, torch.ones_like(one_minus)).prod(dim=1)

    # n_contrib counts positions within the pixel's TILE list (the
    # reference's `contributor` counter, forward.cu:333,359): the rank among
    # in-rect valid gaussians that survive the lossless tile cull
    in_list = pre_sorted.valid[None, :] & in_rect & tile_accepts(
        pre_sorted.mean2d[None, :, 0], pre_sorted.mean2d[None, :, 1],
        pre_sorted.conic[None, :, 0], pre_sorted.conic[None, :, 1],
        pre_sorted.conic[None, :, 2], pre_sorted.opacity[None, :],
        tile_xy[:, None, 0], tile_xy[:, None, 1],
    )
    rank = torch.cumsum(in_list.to(torch.int32), dim=1)
    n_contrib = torch.where(contrib, rank, torch.zeros_like(rank)).amax(dim=1)

    out_color = color + final_T[:, None] * bg_color[None, :]
    return out_color, depth, acc, final_T, n_contrib


class RenderOutput(NamedTuple):
    color: torch.Tensor  # [3, H, W]
    depth: torch.Tensor  # [H, W]
    acc: torch.Tensor  # [H, W] (silhouette)
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32
    radii: torch.Tensor  # [N]
    # Binning diagnostics (no gradient; 0-d int tensors, or 0, read with
    # int() so that rendering never waits on the host): instances dropped
    # by the static budgets (> 0 means images are approximate; consumers
    # escalate max_instances) and the true expansion size. 0 for the oracle.
    overflow: int = 0
    num_instances: int = 0
    # busiest tile's chunk count (tiles backend; 0 for the oracle)
    max_nchunks: int = 0
    # total chunks the tile kernel walks (sum of per-tile neff, the
    # early-stop vote)
    walked_chunks: int = 0


def rasterize_naive(
    means,
    scales,
    quats,
    opacities,
    shs,
    camera: Camera,
    bg_color=None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    active_mask=None,
    pixel_chunk: int = 4096,
) -> RenderOutput:
    """Render C/D/S images; differentiable through all parameters.

    No depth-gradient drop here — this is the raw math. Use
    `gslivm_tpu_torch.ops.rasterize.rasterize` for the reference-parity
    gradient contract.
    """
    H, W = camera.height, camera.width
    if bg_color is None:
        bg_color = torch.ones(3, dtype=means.dtype, device=means.device)

    pre = preprocess(
        means, scales, quats, opacities, shs, camera,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        active_mask=active_mask,
    )
    # the gaussians preprocess culled (valid False, sorted last) take no part
    # in any pixel: composite the valid prefix only (at least one row, to
    # keep the shapes), which reads the valid count back once
    order = depth_order(pre)[:max(int(pre.valid.sum()), 1)]
    pre_sorted = PreprocessedGaussians(*(x[order] for x in pre))

    ys, xs = torch.meshgrid(torch.arange(H, device=means.device),
                            torch.arange(W, device=means.device), indexing="ij")
    pix_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(means.dtype)
    tile_xy = torch.div(pix_xy, TILE, rounding_mode="floor").to(torch.int32)

    outs = [
        _composite_pixels(pix_xy[s:s + pixel_chunk], tile_xy[s:s + pixel_chunk],
                          pre_sorted, bg_color)
        for s in range(0, H * W, pixel_chunk)
    ]
    color, depth, acc, final_T, n_contrib = (torch.cat(o, dim=0) for o in zip(*outs))

    return RenderOutput(
        color=color.reshape(H, W, 3).permute(2, 0, 1),
        depth=depth.reshape(H, W),
        acc=acc.reshape(H, W),
        final_T=final_T.reshape(H, W).detach(),
        n_contrib=n_contrib.reshape(H, W),
        radii=pre.radius.detach(),
        overflow=0,  # the oracle composites everything
        num_instances=pre.tiles_touched.sum(),
    )
