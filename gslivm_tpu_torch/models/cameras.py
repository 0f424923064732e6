"""Camera model and projection conventions (port of gslivm_tpu/models/cameras.py).

Behavioral spec: reference `src/gs/camera.cu` + `src/cuda_rasterizer/auxiliary.h`:
  - Camera ctor (camera.cu:6-56): takes R = camera->world rotation and
    T = camera center in world; world->camera is p_cam = R^T (p_world - T).
  - ndc2Pix (auxiliary.h:35-37): pix = ((ndc + 1) * S - 1) / 2.
  - focal/fov conversion (camera.cu:84-90).

The principal point is always centered for rasterization.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class Camera:
    """A single camera: tensors on one device plus int image dimensions.

    R_cw: [3,3] world->camera rotation.
    t_cw: [3]   world->camera translation (p_cam = R_cw @ p_world + t_cw).
    fx, fy: 0-d focals in pixels for rasterization, = W/(2 tanfovx) etc.
    tan_fovx, tan_fovy: 0-d half-FoV tangents.
    cam_center: [3] camera center in world (for SH view directions).
    K: [3,3] intrinsics (fx, fy, cx, cy) for reprojection losses.
    """

    R_cw: torch.Tensor
    t_cw: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor
    cam_center: torch.Tensor
    K: torch.Tensor
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.R_cw.device


def fov2focal(fov: float, pixels: int) -> float:
    """camera.cu:84-86."""
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    """camera.cu:88-90."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def make_camera(
    R_wc,
    cam_center,
    width: int,
    height: int,
    fovx: float | None = None,
    fovy: float | None = None,
    fx: float | None = None,
    fy: float | None = None,
    cx: float | None = None,
    cy: float | None = None,
    dtype=torch.float32,
    device="cuda",
) -> Camera:
    """Build a Camera from cam->world rotation + camera center (camera.cu:36-40).

    Either (fovx, fovy) or (fx, fy) must be given; the rasterization focal is
    always recomputed from the fov so that pixel coordinates match ndc2Pix.
    The host math runs in float64 and is cast once, as in the JAX package.
    """
    dev = resolve_device(device)
    R_wc = np.asarray(R_wc, dtype=np.float64)
    cam_center = np.asarray(cam_center, dtype=np.float64)
    if fovx is None:
        if fx is None or fy is None:
            raise ValueError("give either (fovx, fovy) or (fx, fy)")
        fovx = focal2fov(fx, width)
        fovy = focal2fov(fy, height)
    tan_fovx = np.tan(fovx / 2.0)
    tan_fovy = np.tan(fovy / 2.0)
    rast_fx = width / (2.0 * tan_fovx)
    rast_fy = height / (2.0 * tan_fovy)
    if fx is None:
        fx, fy = rast_fx, rast_fy
    if cx is None:
        cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    R_cw = R_wc.T
    t_cw = -R_wc.T @ cam_center
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype,
                               device=dev)

    return Camera(
        R_cw=t(R_cw), t_cw=t(t_cw), fx=t(rast_fx), fy=t(rast_fy),
        tan_fovx=t(tan_fovx), tan_fovy=t(tan_fovy), cam_center=t(cam_center),
        K=t(K), width=int(width), height=int(height),
    )


def world_to_cam(camera: Camera, points):
    """[..., 3] world -> camera frame."""
    return points @ camera.R_cw.T + camera.t_cw


def project_to_pixels(camera: Camera, points):
    """World points -> (pixel xy [..., 2], view-space depth [...]).

    The projmatrix + ndc2Pix path of preprocessCUDA (forward.cu:231-234,
    264) including the 1/(w + 1e-7) guard.
    """
    p_view = world_to_cam(camera, points)
    z = p_view[..., 2]
    w_inv = 1.0 / (z + 1e-7)
    ndc_x = (p_view[..., 0] / camera.tan_fovx) * w_inv
    ndc_y = (p_view[..., 1] / camera.tan_fovy) * w_inv
    pix_x = ((ndc_x + 1.0) * camera.width - 1.0) * 0.5
    pix_y = ((ndc_y + 1.0) * camera.height - 1.0) * 0.5
    return torch.stack([pix_x, pix_y], dim=-1), z
