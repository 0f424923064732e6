"""The plain reference renderer: 3D gaussians -> colour, depth and
silhouette of a posed pinhole camera, with its gradient.

A frozen copy of the semantics of `gslivm_tpu_torch/ops/
rasterize_reference.py` (preprocess with the culls, SH band 0 colour,
cov3D from the raw quaternion, EWA cov2D with the 1.3 tan(fov) clamp and
the +0.3 low-pass, the 3-sigma radius, the lossless binning rect, the
16x16 tile-rect membership, alpha = min(0.99, o exp(power)), skip
power > 0 and alpha < 1/255, stop when T (1 - alpha) < 1e-4, depth order
with index tie-break, C + T bg) and of `ops/covariance.py` and `ops/sh.py`,
in plain torch in any float dtype, with none of the program's code.

The composite runs in blocks of BLOCK x BLOCK pixels, each over the
gaussians whose rect meets the block, so a 960x600 view of a few hundred
thousand gaussians fits on one card. `render` returns images and, given
the gradients of the images, accumulates the gradient of the gaussians'
parameters by recomputing each block (no graph is kept across blocks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
BLOCK = 64          # pixels per block side (4 x 4 tiles)
SH_C0 = 0.28209479177387814
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4


class View(NamedTuple):
    """A centred pinhole, world -> camera p_cam = R_cw p + t_cw."""

    R_cw: torch.Tensor   # [3, 3]
    t_cw: torch.Tensor   # [3]
    center: torch.Tensor  # [3]
    fx: float
    fy: float
    tan_x: float
    tan_y: float
    width: int
    height: int
    K: torch.Tensor      # [3, 3] intrinsics (centred principal point)


def make_view(R_wc, center, width: int, height: int, fx: float, fy: float,
              dtype=torch.float64, device="cpu", cx: float | None = None,
              cy: float | None = None) -> View:
    """The rasterization camera of a pose given by camera -> world R_wc
    and its centre, with the focal recomputed from the field of view as
    the rasterizer does (fov = 2 atan(W / 2 fx)). The rasterizer centres
    the principal point; cx, cy (centred unless given) enter only K, which
    the delta-depth warp uses."""
    R_wc = torch.as_tensor(R_wc, dtype=torch.float64)
    c = torch.as_tensor(center, dtype=torch.float64)
    tan_x, tan_y = width / (2.0 * fx), height / (2.0 * fy)
    R_cw = R_wc.T
    cx = (width - 1) / 2.0 if cx is None else cx
    cy = (height - 1) / 2.0 if cy is None else cy
    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=torch.float64)

    def t(x):
        return x.to(dtype=dtype, device=device)

    return View(t(R_cw), t(-R_cw @ c), t(c), width / (2.0 * tan_x), height / (2.0 * tan_y),
                tan_x, tan_y, int(width), int(height), t(K))


class Gaussians(NamedTuple):
    """Raw (unactivated) parameters of the live gaussians, as the map
    stores them: log scales, unnormalised quaternions (w, x, y, z), opacity
    logits, SH band-0 coefficients [N, 3]."""

    xyz: torch.Tensor
    log_scale: torch.Tensor
    rotation: torch.Tensor
    logit: torch.Tensor
    dc: torch.Tensor


class Pre(NamedTuple):
    valid: torch.Tensor
    mean2d: torch.Tensor
    conic: torch.Tensor
    opacity: torch.Tensor
    color: torch.Tensor
    depth: torch.Tensor
    rect_min: torch.Tensor
    rect_max: torch.Tensor


def _rotmat(q):
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def preprocess(g: Gaussians, v: View) -> Pre:
    """Per-gaussian screen quantities, differentiable in g."""
    scales = torch.exp(g.log_scale)
    quats = g.rotation / torch.linalg.norm(g.rotation, dim=-1, keepdim=True).clamp(min=1e-12)
    op = torch.sigmoid(g.logit).reshape(-1)
    p = g.xyz @ v.R_cw.T + v.t_cw
    z = p[:, 2]
    near_ok = z > 0.2
    size_ok = ~torch.any(scales > 0.3, dim=-1)
    z_div = torch.where(near_ok, z, torch.ones_like(z))
    w_inv = 1.0 / (z_div + 1e-7)
    mean2d = torch.stack([((p[:, 0] / v.tan_x * w_inv + 1.0) * v.width - 1.0) * 0.5,
                          ((p[:, 1] / v.tan_y * w_inv + 1.0) * v.height - 1.0) * 0.5], -1)
    R = _rotmat(quats)
    sigma3 = R @ torch.diag_embed(scales * scales) @ R.transpose(-1, -2)
    tz = torch.where(z_div.abs() > 1e-6, z_div, torch.full_like(z_div, 1e-6))
    tx = torch.clamp(p[:, 0] / tz, -1.3 * v.tan_x, 1.3 * v.tan_x) * tz
    ty = torch.clamp(p[:, 1] / tz, -1.3 * v.tan_y, 1.3 * v.tan_y) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([v.fx / tz, zero, -v.fx * tx / (tz * tz)], -1),
                     torch.stack([zero, v.fy / tz, -v.fy * ty / (tz * tz)], -1)], -2)
    T = J @ v.R_cw
    cov2 = T @ sigma3 @ T.transpose(-1, -2)
    a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))
    rstar = torch.sqrt(torch.clamp(2.0 * torch.log(torch.clamp(255.0 * op, min=1e-12)),
                                   min=0.0)) * (1.0 + 1e-5)
    hx = torch.minimum(radius, rstar * torch.sqrt(torch.clamp(a, min=0.0))).detach()
    hy = torch.minimum(radius, rstar * torch.sqrt(torch.clamp(c, min=0.0))).detach()
    gx, gy = (v.width + TILE - 1) // TILE, (v.height + TILE - 1) // TILE
    m2 = mean2d.detach()
    lo = torch.stack([torch.trunc((m2[:, 0] - hx) / TILE), torch.trunc((m2[:, 1] - hy) / TILE)], -1)
    hi = torch.stack([torch.trunc((m2[:, 0] + hx + TILE - 1) / TILE),
                      torch.trunc((m2[:, 1] + hy + TILE - 1) / TILE)], -1)
    lim = torch.tensor([gx, gy], device=lo.device)
    rect_min = torch.minimum(torch.clamp(lo.long(), min=0), lim)
    rect_max = torch.minimum(torch.clamp(hi.long(), min=0), lim)
    tiles = (rect_max - rect_min).prod(-1)
    valid = near_ok & size_ok & det_ok & (tiles > 0)
    color = torch.clamp(SH_C0 * g.dc + 0.5, min=0.0)  # band 0 has no view direction
    return Pre(valid, mean2d, conic, op, color, z, rect_min, rect_max)


def _blocks(v: View):
    for y0 in range(0, v.height, BLOCK):
        for x0 in range(0, v.width, BLOCK):
            yield x0, y0, min(x0 + BLOCK, v.width), min(y0 + BLOCK, v.height)


def _composite(pre: Pre, idx, x0, y0, x1, y1, bg):
    """Colour [3, h, w], depth [h, w], acc [h, w] and the number of
    (gaussian, pixel) pairs that contribute, over the gaussians `idx` in
    depth order."""
    dev, dt = pre.mean2d.device, pre.mean2d.dtype
    ys, xs = torch.meshgrid(torch.arange(y0, y1, device=dev), torch.arange(x0, x1, device=dev),
                            indexing="ij")
    px = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    tile = torch.div(px, TILE, rounding_mode="floor")
    m, cn = pre.mean2d[idx], pre.conic[idx]
    d = px.to(dt)[:, None, :] - m[None]
    power = (-0.5 * (cn[None, :, 0] * d[..., 0] ** 2 + cn[None, :, 2] * d[..., 1] ** 2)
             - cn[None, :, 1] * d[..., 0] * d[..., 1])
    in_rect = torch.all((tile[:, None] >= pre.rect_min[idx][None])
                        & (tile[:, None] < pre.rect_max[idx][None]), dim=-1)
    alpha = torch.clamp(pre.opacity[idx][None] * torch.exp(power), max=0.99)
    ok = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a_eff = torch.where(ok, alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - a_eff
    T_prev = torch.cat([torch.ones_like(a_eff[:, :1]), torch.cumprod(one_minus, 1)[:, :-1]], 1)
    stop = ok & (T_prev * (1.0 - alpha) < T_STOP)
    contrib = ok & ~(torch.cumsum(stop.to(torch.int32), 1) > 0)
    w = torch.where(contrib, a_eff * T_prev, torch.zeros_like(a_eff))
    T_final = torch.where(contrib, one_minus, torch.ones_like(one_minus)).prod(1)
    color = w @ pre.color[idx] + T_final[:, None] * bg[None]
    depth = w @ pre.depth[idx]
    acc = w.sum(1)
    h, wd = y1 - y0, x1 - x0
    return (color.T.reshape(3, h, wd), depth.reshape(h, wd), acc.reshape(h, wd),
            int(contrib.sum()))


def _order(pre: Pre):
    valid = torch.nonzero(pre.valid).reshape(-1)
    key = pre.depth.detach()[valid]
    return valid[torch.argsort(key, stable=True)]


def _block_members(pre: Pre, order, x0, y0, x1, y1):
    rmin, rmax = pre.rect_min[order], pre.rect_max[order]
    hit = ((rmin[:, 0] * TILE < x1) & (rmax[:, 0] * TILE > x0)
           & (rmin[:, 1] * TILE < y1) & (rmax[:, 1] * TILE > y0))
    return order[hit]


class Render(NamedTuple):
    color: torch.Tensor  # [3, H, W]
    depth: torch.Tensor  # [H, W]
    acc: torch.Tensor    # [H, W]
    pairs: int           # contributing (gaussian, pixel) pairs
    visible: int         # gaussians that survive the culls


def render(g: Gaussians, v: View, bg, grad_color=None) -> Render:
    """Render view v. With grad_color [3, H, W] (dL/dcolour, the depth
    gradient dropped as the program's contract does), accumulate dL/dg
    into the .grad of g's leaves and return the same images."""
    with torch.no_grad():
        pre = preprocess(g, v)
        order = _order(pre)
        H, W = v.height, v.width
        color = torch.empty((3, H, W), dtype=pre.mean2d.dtype, device=pre.mean2d.device)
        depth = torch.empty((H, W), dtype=color.dtype, device=color.device)
        acc = torch.empty_like(depth)
        members = []
        pairs = 0
        for x0, y0, x1, y1 in _blocks(v):
            idx = _block_members(pre, order, x0, y0, x1, y1)
            members.append(idx)
            c, d, a, n = _composite(pre, idx, x0, y0, x1, y1, bg)
            color[:, y0:y1, x0:x1], depth[y0:y1, x0:x1], acc[y0:y1, x0:x1] = c, d, a
            pairs += n
    if grad_color is not None:
        with torch.enable_grad():
            pre_g = preprocess(g, v)
            leaves = [pre_g.mean2d, pre_g.conic, pre_g.opacity, pre_g.color]
            det = [x.detach().requires_grad_(True) for x in leaves]
            pre_d = pre_g._replace(mean2d=det[0], conic=det[1], opacity=det[2], color=det[3],
                                   depth=pre_g.depth.detach())
            for (x0, y0, x1, y1), idx in zip(_blocks(v), members):
                c = _composite(pre_d, idx, x0, y0, x1, y1, bg)[0]
                torch.autograd.backward(c, grad_color[:, y0:y1, x0:x1], inputs=det)
            torch.autograd.backward(leaves, [x.grad for x in det])
    return Render(color, depth, acc, pairs, int(pre.valid.sum()))


def contributing_pairs(g: Gaussians, v: View, bg) -> tuple[int, int]:
    """(pairs, visible): the (gaussian, pixel) pairs that any correct
    compositor of view v must evaluate, alpha >= 1/255 while the pixel's
    transmittance has not stopped, and the gaussians that survive the
    culls."""
    r = render(g, v, bg)
    return r.pairs, r.visible
