"""Voxel-GP illustration figures (the port's own copy of
gslivm_tpu/tools/gp_figure.py; plot_figure.py port).

Port of `python/plot_figure.py` (reference): visualizes the voxel-GPR
pipeline — (1) the GP-regressed surface with per-point variance coloring
and the predicted sample points, (2) the 3x3-neighbourhood ellipsoid fit
(fastInitial3DGS, gpprocess.cu:420-458) with shortest-axis normals. The
reference script uses sklearn's RBF GP as a stand-in; this port runs the
FRAMEWORK'S actual voxel GP (ops.gp3d: OU kernel, fast-init moments) on a
synthetic cell, so the figures show the production math.

The computation (`compute`: the cell and `gp_forward` on it) runs on
--device, the card by default; the plot is drawn on the host with
matplotlib, imported then (the card machine has none).
Headless-friendly: saves PNGs to --out (default ./gp_figure_*.png).

Usage: python -m gslivm_tpu_torch.tools.gp_figure [--out DIR] [--seed N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

GRID = 0.4


def _make_cell(rng, cfg, device):
    """One surface-like voxel cell: ripply height field over (x, y)."""
    from ..ops import gp3d  # noqa: PLC0415

    nt = cfg.min_points_num_to_gp
    u = rng.uniform(0, cfg.grid, nt)
    w = rng.uniform(0, cfg.grid, nt)
    f = 0.05 * np.sin(12.0 * u) * np.cos(9.0 * w) + 0.03 * u
    pts = np.stack([u, w, f + cfg.grid / 2], axis=1)
    return gp3d.GpBatch(
        points=torch.as_tensor(pts[None], dtype=torch.float32, device=device),
        variance=torch.full((1, nt), cfg.variance_sensor, dtype=torch.float32,
                            device=device),
        direction=torch.tensor([2], dtype=torch.int32, device=device),  # project along z
        region_min=torch.zeros((1, 3), dtype=torch.float32, device=device),
        mask=torch.ones((1,), dtype=torch.bool, device=device),
    )


def compute(seed: int = 42, device="cuda"):
    """The figure's cell and the port's `gp_forward` on it, on `device`:
    (GpBatch, GpResult)."""
    from ..config import GpParams  # noqa: PLC0415
    from ..ops import gp3d  # noqa: PLC0415
    from ..utils.device import resolve_device  # noqa: PLC0415

    cfg = GpParams(grid=GRID)
    batch = _make_cell(np.random.default_rng(seed), cfg, resolve_device(device))
    return batch, gp3d.gp_forward(batch, cfg)


def _plot_ellipsoid(ax, mean, cov, n_std=3.0, color="#A3C2A3",
                    quiver_label=None):
    """Wireframe ellipsoid + shortest-principal-axis arrow
    (plot_figure.py plot_ellipsoid)."""
    U, s, _ = np.linalg.svd(cov)
    radii = n_std * np.sqrt(np.maximum(s, 1e-12))
    u = np.linspace(0.0, 2 * np.pi, 24)
    v = np.linspace(0.0, np.pi, 12)
    x = radii[0] * np.outer(np.cos(u), np.sin(v))
    y = radii[1] * np.outer(np.sin(u), np.sin(v))
    z = radii[2] * np.outer(np.ones_like(u), np.cos(v))
    pts = np.stack([x, y, z], axis=-1) @ U.T + mean
    ax.plot_wireframe(pts[..., 0], pts[..., 1], pts[..., 2], rstride=1,
                      cstride=4, color=color, linewidth=0.4)
    k = int(np.argmin(s))
    arrow = U[:, k] * 0.6 * n_std * np.sqrt(s.mean())
    ax.quiver(mean[0], mean[1], mean[2], arrow[0], arrow[1], arrow[2],
              color="r", arrow_length_ratio=0.1, label=quiver_label)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=".")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..config import GpParams  # noqa: PLC0415

    batch, res = compute(args.seed, args.device)

    import matplotlib  # noqa: PLC0415

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: PLC0415
    from matplotlib.colors import Normalize  # noqa: PLC0415

    world = res.test_points[0].cpu().numpy()       # [144, 3]
    var = 1.0 - res.test_var[0].cpu().numpy()      # unexplained variance
    side = GpParams(grid=GRID).test_side
    X = world[:, 0].reshape(side, side)
    Y = world[:, 1].reshape(side, side)
    Z = world[:, 2].reshape(side, side)

    # ---- figure 1: GP surface colored by variance (plot_surface_with_...)
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    norm = Normalize(vmin=float(var.min()), vmax=float(var.max() + 1e-9))
    colors = plt.cm.RdYlGn(1 - (var - var.min())
                           / max(var.max() - var.min(), 1e-9)).reshape(
        side, side, 4)
    ax.plot_surface(X, Y, Z, facecolors=colors, alpha=0.6, linewidth=0)
    cbar = fig.colorbar(plt.cm.ScalarMappable(norm=norm,
                                              cmap=plt.cm.RdYlGn_r),
                        ax=ax, shrink=1, aspect=30)
    cbar.set_label("Variance")
    train = batch.points[0].cpu().numpy()
    ax.scatter(train[:, 0], train[:, 1], train[:, 2], color="black", s=40,
               label="Train point")
    ax.scatter(world[:, 0], world[:, 1], world[:, 2], color="blue", s=8,
               label="Predicted point")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend()
    p1 = os.path.join(args.out, "gp_figure_surface.png")
    fig.savefig(p1, dpi=110, bbox_inches="tight")
    plt.close(fig)

    # ---- figure 2: fast-init ellipsoids (plot_all_ellipsoid) -------------
    means = res.means[0].cpu().numpy()   # [16, 3]
    covs = res.covs[0].cpu().numpy()     # [16, 3, 3]
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    for i, (m, c) in enumerate(zip(means, covs)):
        _plot_ellipsoid(ax, m, c,
                        quiver_label="Normals" if i == 0 else None)
    ax.scatter(world[:, 0], world[:, 1], world[:, 2], color="blue", s=8,
               label="Predicted point")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend()
    p2 = os.path.join(args.out, "gp_figure_ellipsoids.png")
    fig.savefig(p2, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {p1} and {p2}")
    return [p1, p2]


if __name__ == "__main__":
    main()
