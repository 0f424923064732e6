"""Batched voxel Gaussian-process regression (port of gslivm_tpu/ops/gp3d.py).

Behavioral spec: reference `src/gp3d/gpprocess.cu` — per-voxel 2.5D GP
regression, batched across voxels:

  - direction-projected training data (processVoxelsKernel:142-159): each
    surface cell regresses f(c1, c2) where (c1, c2, f) is a permutation of
    (x, y, z) chosen by PCA (cell.cpp); f is mean-centered.
  - uniform test grid of test_side^2 points (12x12 = 144) at cell-relative
    coordinates (deviceEvenSetLinSpaced:7-12; +0.5-interval offsets unless
    full_cover).
  - OU kernel K = exp(-kernel_size * dist2d) with per-point sensor
    variance^2 on the diagonal (computeKernelMatrices:16-46).
  - posterior mean f* = K* K^-1 f and "explained variance"
    v = diag(K* K^-1 K*^T) (gpprocess.cu:602-668), solved by Cholesky as
    in the JAX package (the reference inverts by LU; K is SPD).
  - variance gate (processVoxelsVarianceKernel:63-122): var_mean =
    1 - mean(v); > max_var_mean reopens the voxel, with per-train-point
    updates 0.2*(1 - kvar[x_idx, y_idx]) where (x_idx, y_idx) are the train
    point's TEST-GRID coordinates: the reference indexes the 144x144
    covariance at [x_idx, y_idx] (both < 12), the covariance between
    low-index test points, and so does this port. var_mean outside [0,1] is
    the reference's exit(-404); here a reported error mask.
  - fastInitial3DGS (gpprocess.cu:420-458): 144 samples -> 4x4 blocks of
    3x3 -> 16 gaussians per voxel by inverse-"variance" weighted mean and
    covariance.
  - colorization (getColors:917-983): world->camera, radial distortion,
    nearest-pixel sample; out of image -> invalid.

Everything runs in float32 on the batch's device, V (the padded voxel batch)
leading. The small batched solves are library calls, as they are XLA's in
the JAX package: `torch.linalg.cholesky_ex` (no host check of its info, so
no sync) and `torch.cholesky_solve`. A factorisation that fails gives NaN
rows, as `jnp.linalg.cholesky` does. The einsums must run in full f32: with
TF32 matmuls allowed (`torch.backends.cuda.matmul.allow_tf32`, or
`set_float32_matmul_precision("high")`) var_mean moves near its threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GpParams

# (c1, c2, f) world-axis indices per direction (processVoxelsKernel:142-159)
_PERM = ((1, 2, 0), (2, 0, 1), (0, 1, 2))


class GpBatch(NamedTuple):
    """A padded batch of surface cells ready for GP regression."""

    points: torch.Tensor      # [V, NT, 3] world train points (last NT of cell)
    variance: torch.Tensor    # [V, NT] per-point sensor std
    direction: torch.Tensor   # [V] int32 in {0,1,2}
    region_min: torch.Tensor  # [V, 3] voxel min corner (world)
    mask: torch.Tensor        # [V] bool


class GpResult(NamedTuple):
    test_points: torch.Tensor  # [V, T, 3] GP sample points (world)
    test_var: torch.Tensor     # [V, T] explained variance (kvar diagonal)
    var_mean: torch.Tensor     # [V] 1 - mean(explained)
    reopen: torch.Tensor       # [V] bool, var_mean > max_var_mean
    update_variance: torch.Tensor  # [V, NT] new per-point variances (x0.2)
    error: torch.Tensor        # [V] bool, var_mean outside [0,1] (ref -404)
    means: torch.Tensor        # [V, 16, 3] fast-init gaussian centers
    covs: torch.Tensor         # [V, 16, 3, 3] fast-init covariances
    loss_points: torch.Tensor  # [V, 5, 3] every-30th test point (loss anchors
                               # for reopened voxels, gpprocess.cu:783-789)


@torch.no_grad()
def gp_forward(batch: GpBatch, cfg: GpParams = GpParams()) -> GpResult:
    dev = batch.points.device
    V, NT, _ = batch.points.shape
    S = cfg.test_side          # 12
    T = S * S                  # 144
    interval = cfg.grid / ((S - 1) if cfg.full_cover else S)

    perm = torch.as_tensor(_PERM, dtype=torch.int64, device=dev)[batch.direction.long()]  # [V, 3]
    inv_perm = torch.argsort(perm, dim=-1)

    proj = torch.take_along_dim(batch.points, perm[:, None, :], dim=2)  # [V, NT, 3]
    c1, c2, f = proj[..., 0], proj[..., 1], proj[..., 2]
    f_mean = f.mean(dim=1, keepdim=True)
    fc = f - f_mean  # [V, NT]

    mins = torch.take_along_dim(batch.region_min, perm[:, :2], dim=1)  # [V, 2]

    # test grid (deviceEvenSetLinSpaced): i//S along c1, i%S along c2
    ii = torch.arange(T, device=dev) // S
    jj = torch.arange(T, device=dev) % S
    offset = 0.0 if cfg.full_cover else 0.5
    t1 = mins[:, 0:1] + interval * (ii[None, :] + offset)  # [V, T]
    t2 = mins[:, 1:2] + interval * (jj[None, :] + offset)

    # kernel matrices (OU kernel on 2D distance)
    dtrain = torch.sqrt((c1[:, :, None] - c1[:, None, :]) ** 2
                        + (c2[:, :, None] - c2[:, None, :]) ** 2)  # [V, NT, NT]
    K = torch.exp(-cfg.kernel_size * dtrain) + torch.einsum(
        "vn,nm->vnm", batch.variance ** 2, torch.eye(NT, device=dev))

    dstar = torch.sqrt((c1[:, None, :] - t1[:, :, None]) ** 2
                       + (c2[:, None, :] - t2[:, :, None]) ** 2)  # [V, T, NT]
    Kstar = torch.exp(-cfg.kernel_size * dstar)

    # Cholesky solve; a failed factorisation gives NaN rows, as in JAX
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info != 0)[:, None, None], float("nan"), L)
    A = torch.cholesky_solve(Kstar.transpose(1, 2), L)  # [V, NT, T]
    f_star = torch.einsum("vn,vnt->vt", fc, A) + f_mean  # [V, T]
    v_expl = torch.einsum("vtn,vnt->vt", Kstar, A)       # [V, T] kvar diagonal

    # reassemble world points: (c1, c2, f) scattered back through inv_perm
    proj_pts = torch.stack([t1, t2, f_star], dim=-1)  # [V, T, 3]
    world = torch.take_along_dim(proj_pts, inv_perm[:, None, :], dim=2)

    var_mean = 1.0 - v_expl.mean(dim=1)
    error = ((var_mean > 1.0) | (var_mean < 0.0)) & batch.mask
    reopen = (var_mean > cfg.max_var_mean) & batch.mask & ~error

    # parity variance update: kvar[x_idx, y_idx] with train-point grid
    # coords (truncation toward zero, as astype(int32))
    x_idx = torch.clamp(_trunc_int32((c1 - mins[:, 0:1]) / interval), 0, S - 1).long()
    y_idx = torch.clamp(_trunc_int32((c2 - mins[:, 1:2]) / interval), 0, S - 1).long()
    # kvar[a, b] = Kstar[a] @ A[:, b]
    kvar_small = torch.einsum("vam,vmb->vab", Kstar[:, :S, :], A[:, :, :S])  # [V, S, S]
    upd = 1.0 - kvar_small[torch.arange(V, device=dev)[:, None], x_idx, y_idx]  # [V, NT]
    update_variance = 0.2 * upd

    means, covs = _fast_initial_3dgs(world, v_expl, cfg)

    loss_points = world[:, ::30, :]  # indices 0,30,60,90,120 (5 points)

    return GpResult(
        test_points=world, test_var=v_expl, var_mean=var_mean, reopen=reopen,
        update_variance=update_variance, error=error, means=means, covs=covs,
        loss_points=loss_points)


def _fast_initial_3dgs(world, v_expl, cfg: GpParams):
    """fastInitial3DGS (gpprocess.cu:420-458): 3x3 neighbourhoods -> 16
    weighted gaussians. weights = 1/explained-variance (reference semantics;
    clamped at 1e-12 to avoid inf on pathological cells)."""
    V = world.shape[0]
    S = cfg.test_side
    nb = cfg.neighbour_size
    gs = S // nb  # grid_size = 4

    pts = world.reshape(V, gs, nb, gs, nb, 3).permute(0, 1, 3, 2, 4, 5)
    pts = pts.reshape(V, gs * gs, nb * nb, 3)  # [V, 16, 9, 3]
    var = v_expl.reshape(V, gs, nb, gs, nb).permute(0, 1, 3, 2, 4)
    var = var.reshape(V, gs * gs, nb * nb)  # [V, 16, 9]

    w = 1.0 / torch.clamp(var, min=1e-12)
    wsum = w.sum(dim=-1, keepdim=True)
    mean = torch.einsum("vgk,vgkc->vgc", w, pts) / wsum  # [V, 16, 3]
    centered = pts - mean[:, :, None, :]
    cov = torch.einsum("vgk,vgkc,vgkd->vgcd", w, centered, centered) / wsum[..., None]
    return mean, cov


def _trunc_int32(x):
    """trunc(x) as int32, saturating as XLA's convert does (NaN -> 0, out of
    range -> the nearest end); a plain .to(int32) is undefined there and
    differs between the CPU and the card."""
    return torch.trunc(torch.nan_to_num(x, nan=0.0)).clamp(-2.0**31, 2.0**31 - 128).to(torch.int32)


class CameraProjection(NamedTuple):
    """World->camera transform + distorted pinhole intrinsics for
    colorization (camOptions, gp_types.h:61-75), as tensors on one device."""

    R_wc: torch.Tensor  # [3,3] world->camera rotation
    t_wc: torch.Tensor  # [3]
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [4] radial distortion d0..d3


@torch.no_grad()
def colorize(points, proj: CameraProjection, image):
    """getColors + projectPointsToImage (gpprocess.cu:917-983).

    points: [..., 3] world; image: [H, W, 3] RGB (uint8 or float) tensor on
    the points' device. Returns (colors [..., 3] float32, valid [...] bool).
    Nearest-pixel sampling with truncation toward zero (saturating, as
    jnp's astype(int32): a NaN coordinate reads pixel 0), radial distortion
    r*(1 + d0 r^2 + d1 r^4 + d2 r^6 + d3 r^8). Valid means inside the image
    only: the reference samples behind-camera points too (no Z > 0 check,
    gpprocess.cu:942-957).
    """
    H, W = image.shape[:2]
    p_cam = points @ proj.R_wc.T + proj.t_wc
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zsafe = torch.where(Z != 0, Z, 1.0)
    xp = X / zsafe
    yp = Y / zsafe
    r2 = xp * xp + yp * yp
    r = torch.sqrt(r2)
    d0, d1, d2, d3 = proj.dist[0], proj.dist[1], proj.dist[2], proj.dist[3]
    rd = r * (1 + d0 * r2 + d1 * r2 ** 2 + d2 * r2 ** 3 + d3 * r2 ** 4)
    scale = torch.where(r > 0, rd / torch.where(r > 0, r, 1.0), 1.0)
    u = _trunc_int32(proj.fx * xp * scale + proj.cx)
    v = _trunc_int32(proj.fy * yp * scale + proj.cy)
    valid = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    ui = torch.clamp(u, 0, W - 1).long()
    vi = torch.clamp(v, 0, H - 1).long()
    colors = image[vi, ui].to(torch.float32)
    return colors, valid
