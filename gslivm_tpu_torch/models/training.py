"""Map rendering for training and serving (port of
gslivm_tpu/models/training.py; this slice holds render_params only — the
train step, its losses and Adam come with the training slice)."""

from __future__ import annotations

from ..ops.rasterize import RasterizeSettings, rasterize
from .cameras import Camera
from .gaussian_model import GaussianParams


def render_params(params: GaussianParams, camera: Camera, bg_color,
                  settings: RasterizeSettings):
    """render() equivalent (render_utils.cuh:13-56): activations + rasterize.

    With the default "auto" backend a map on the card renders through the
    K1 tile kernel, forward only: call it under torch.no_grad().
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
