"""Public rasterization API (port of gslivm_tpu/ops/rasterize.py).

Gradient contract (parity with _RasterizeGaussians, rasterizer.cu:71-110):
the backward consumes only dL/d_color and dL/d_acc; the incoming depth
gradient is silently DROPPED (rasterizer.cu:79). `depth_grad=True` lifts
this restriction.

Backends:
  - "naive": the O(P*pixels) torch oracle (rasterize_reference.py),
    differentiable by autograd.
  - "tiles": tile-binned rendering through the tile kernels
    (rasterize_tiles.py): K1 forward and, for a gradient, K1 with
    checkpoints and the backward kernel K2. On CPU tensors it runs their
    plain versions. With depth_grad=False its backward skips the depth
    term, whose cotangent the contract drops anyway.
  - "auto": "tiles" for CUDA tensors, "naive" otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rasterize_reference import RenderOutput, rasterize_naive


class RasterizeSettings(NamedTuple):
    """Static rasterization configuration (GaussianRasterizationSettings,
    rasterizer.cuh:8-20, minus the per-camera tensors in `Camera`)."""

    sh_degree: int = 0
    scale_modifier: float = 1.0
    depth_grad: bool = False
    backend: str = "auto"
    # tile-backend budgets (the JAX package's defaults; its mapper fits them
    # to the measured expansion)
    max_instances: int = 2**20
    max_chunks_per_tile: int = 64
    capacity_slack: float = 0.35
    # supertile factor: one K1 block renders a 32x32 pixel block
    block_x: int = 2
    block_y: int = 2
    # per-pixel n_contrib statistics (tiles only); False renders zeros
    contrib_stats: bool = True


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend != "auto":
        return backend
    return "tiles" if device.type == "cuda" else "naive"


def _render_impl(settings: RasterizeSettings, camera, means, scales, quats,
                 opacities, shs, bg_color, active_mask) -> RenderOutput:
    backend = _resolve_backend(settings.backend, means.device)
    if backend == "naive":
        return rasterize_naive(
            means, scales, quats, opacities, shs, camera,
            bg_color=bg_color,
            sh_degree=settings.sh_degree,
            scale_modifier=settings.scale_modifier,
            active_mask=active_mask,
        )
    if backend == "tiles":
        from .rasterize_tiles import rasterize_tiles  # noqa: PLC0415

        return rasterize_tiles(
            means, scales, quats, opacities, shs, camera,
            bg_color=bg_color,
            sh_degree=settings.sh_degree,
            scale_modifier=settings.scale_modifier,
            active_mask=active_mask,
            max_instances=settings.max_instances,
            max_chunks_per_tile=settings.max_chunks_per_tile,
            capacity_slack=settings.capacity_slack,
            block_x=settings.block_x,
            block_y=settings.block_y,
            depth_grad=settings.depth_grad,
            contrib_stats=settings.contrib_stats,
        )
    raise ValueError(f"unknown rasterizer backend: {backend!r}")


class _DropDepthGrad(torch.autograd.Function):
    """Identity on the depth image whose backward returns zeros: the
    reference's silent depth-grad drop (rasterizer.cu:79). depth stays in
    the graph, so d(depth)/d(params) is 0 rather than an error."""

    @staticmethod
    def forward(ctx, depth):
        return depth.view_as(depth)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def rasterize(
    means,
    scales,
    quats,
    opacities,
    shs,
    camera,
    bg_color=None,
    settings: RasterizeSettings = RasterizeSettings(),
    active_mask=None,
) -> RenderOutput:
    """Render a camera view of the Gaussian map.

    means [N, 3]; scales [N, 3] ACTIVATED; quats [N, 4] (w,x,y,z), passed
    through unnormalized (forward.cu:146); opacities [N] or [N, 1]
    ACTIVATED; shs [N, K, 3]; bg_color [3], white by default; active_mask
    [N] bool for capacity-padded buffers.

    Returns RenderOutput(color [3,H,W], depth [H,W], acc [H,W], ...).
    """
    if bg_color is None:
        bg_color = torch.ones(3, dtype=means.dtype, device=means.device)
    if opacities.dim() == 2:
        opacities = opacities[:, 0]
    if active_mask is None:
        active_mask = torch.ones(means.shape[0], dtype=torch.bool,
                                 device=means.device)
    out = _render_impl(settings, camera, means, scales, quats, opacities, shs,
                       bg_color, active_mask)
    if settings.depth_grad or not out.depth.requires_grad:
        return out
    return out._replace(depth=_DropDepthGrad.apply(out.depth))


def mark_visible(means, camera):
    """Frustum visibility test (markVisible, rasterizer.cu:226-241 ->
    in_frustum, auxiliary.h:120-144): True where view-space z > 0.2."""
    p_view = means @ camera.R_cw.T + camera.t_cw
    return p_view[..., 2] > 0.2
