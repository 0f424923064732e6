"""Trajectory visualization (the port's own copy of
gslivm_tpu/tools/traj_plot.py; python/verbose_traj.py parity): 3-D path +
per-axis position and quaternion curves from a TUM-format pose file.

Headless (Agg backend); writes PNGs instead of opening windows. matplotlib
is imported when a plot is drawn; the card machine has none.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def plot_trajectory(tum_path: str, out_dir: str) -> list[str]:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.trajectory import load_tum

    t, pos, quat = load_tum(tum_path)
    os.makedirs(out_dir, exist_ok=True)
    written = []

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], lw=1.0)
    ax.scatter(*pos[0], color="green", label="start")
    ax.scatter(*pos[-1], color="red", label="end")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend()
    p = os.path.join(out_dir, "trajectory_3d.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for i, lab in enumerate("xyz"):
        axes[0].plot(t, pos[:, i], label=lab, lw=0.8)
    axes[0].set_ylabel("position [m]")
    axes[0].legend()
    for i, lab in enumerate(["qx", "qy", "qz", "qw"]):
        axes[1].plot(t, quat[:, i], label=lab, lw=0.8)
    axes[1].set_ylabel("quaternion")
    axes[1].set_xlabel("time [s]")
    axes[1].legend(ncol=4)
    p = os.path.join(out_dir, "trajectory_components.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tum_file")
    ap.add_argument("--out", default="traj_plots")
    args = ap.parse_args(argv)
    for p in plot_trajectory(args.tum_file, args.out):
        print(p)


if __name__ == "__main__":
    main()
