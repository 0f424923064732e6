"""The plain reference of the batched voxel GP regression that seeds the
map's gaussians, held against what the program's `gp_forward` produced on
the same batch.

A frozen copy of the semantics of `gslivm_tpu_torch/ops/gp3d.py`
(`gp_forward` up to the fast-init gaussians, `_fast_initial_3dgs`): each
surface cell regresses f(c1, c2), a permutation of (x, y, z) chosen by the
cell's direction, mean-centred; a 12 x 12 test grid at +0.5 intervals
(full_cover off); the OU kernel exp(-kernel_size * dist2d) with the
per-point sensor variance squared on the diagonal; the posterior mean and
explained variance by a Cholesky solve; then 16 gaussians a cell, each
the inverse-variance weighted mean of a 3 x 3 block of the test grid.
In plain torch, in float64; the control takes the batch's coordinates in
bfloat16 (Cholesky has no bfloat16 kernel, so the arithmetic after that
rounding runs in float32).
"""

from __future__ import annotations

import torch

_PERM = ((1, 2, 0), (2, 0, 1), (0, 1, 2))


def gp_means(points, variance, direction, region_min, gp: dict, dtype=torch.float64):
    """[V, 16, 3] fast-init centres of a batch of cells (points [V, NT, 3],
    variance [V, NT], direction [V], region_min [V, 3])."""
    S = gp["num_gp_side"] * gp["neighbour_size"]
    nb = gp["neighbour_size"]
    T = S * S
    interval = gp["grid"] / S
    dev = points.device
    pts, var, mins3 = points.to(dtype), variance.to(dtype), region_min.to(dtype)
    V, NT = pts.shape[:2]
    perm = torch.as_tensor(_PERM, device=dev)[direction.long()]
    proj = torch.take_along_dim(pts, perm[:, None, :], dim=2)
    c1, c2, f = proj[..., 0], proj[..., 1], proj[..., 2]
    f_mean = f.mean(dim=1, keepdim=True)
    mins = torch.take_along_dim(mins3, perm[:, :2], dim=1)
    ii = torch.arange(T, device=dev) // S
    jj = torch.arange(T, device=dev) % S
    t1 = mins[:, 0:1] + interval * (ii[None, :] + 0.5)
    t2 = mins[:, 1:2] + interval * (jj[None, :] + 0.5)
    d = torch.sqrt((c1[:, :, None] - c1[:, None, :]) ** 2 + (c2[:, :, None] - c2[:, None, :]) ** 2)
    K = torch.exp(-gp["kernel_size"] * d) + torch.diag_embed(var ** 2)
    ds = torch.sqrt((c1[:, None, :] - t1[:, :, None]) ** 2 + (c2[:, None, :] - t2[:, :, None]) ** 2)
    Ks = torch.exp(-gp["kernel_size"] * ds)                       # [V, T, NT]
    L, info = torch.linalg.cholesky_ex(K)
    A = torch.cholesky_solve(Ks.transpose(1, 2), L)               # [V, NT, T]
    f_star = (A.transpose(1, 2) @ (f - f_mean)[:, :, None])[..., 0] + f_mean
    v = (Ks * A.transpose(1, 2)).sum(-1)                          # [V, T]
    world = torch.take_along_dim(torch.stack([t1, t2, f_star], -1),
                                 torch.argsort(perm, dim=-1)[:, None, :], dim=2)
    gs = S // nb
    blocks = world.reshape(V, gs, nb, gs, nb, 3).permute(0, 1, 3, 2, 4, 5).reshape(V, gs * gs,
                                                                                   nb * nb, 3)
    w = 1.0 / torch.clamp(v.reshape(V, gs, nb, gs, nb).permute(0, 1, 3, 2, 4)
                          .reshape(V, gs * gs, nb * nb), min=1e-12)
    means = (w[..., None] * blocks).sum(2) / w.sum(-1, keepdim=True)
    return torch.where((info != 0)[:, None, None], float("nan"), means)


def mean_gap_mm(program_means, points, variance, direction, region_min, mask, gp: dict,
                control: bool = False) -> float | None:
    """The widest gap in mm between the program's centres and the
    reference's over the batch's cells where both are finite (a cell whose
    factorisation fails in float32 is one the program gives no centre); inf
    where over a tenth of the reference's cells have no finite centre; None
    for a batch that holds no cell."""
    if control:
        def low(x):
            return x.to(torch.bfloat16).to(torch.float32)

        got = gp_means(low(points), low(variance), direction, low(region_min), gp,
                       torch.float32)
    else:
        got = program_means
    ref = gp_means(points, variance, direction, region_min, gp)
    got = got.double()
    cells = mask & torch.isfinite(ref).all(-1).all(-1)
    both = cells & torch.isfinite(got).all(-1).all(-1)
    if not bool(cells.any()):
        return None
    if int(both.sum()) < 0.9 * int(cells.sum()):
        return float("inf")
    ok = both[:, None, None].expand_as(ref)
    gap = torch.where(ok, (got - ref).abs(), torch.zeros_like(ref))
    return float(gap.max()) * 1e3
