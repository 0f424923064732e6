"""Depth-map viewer: colormap a saved .npy / .png / .jpg depth image (the
port's own copy of gslivm_tpu/tools/see_image.py).

Port of `python/see_image.py` (reference): loads a depth array from .npy
(saveDepthMapAsNPY, lioOptimization.cpp:2138-2148) or an image file and
renders it through a colormap. Images are read by the port's own decoders
(`frontend/png.py`, `frontend/jpeg.py` with its reconstruction on
--device) in cv2.imread(IMREAD_UNCHANGED)'s layout: a gray image as [H, W],
a colour one with its channels in BGR(A) order. matplotlib is imported
when the plot is drawn; the card machine has none. Headless-friendly:
--out saves a PNG instead of opening a window.

Usage: python -m gslivm_tpu_torch.tools.see_image DEPTH.npy [--out OUT.png]
       [--cmap viridis] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_depth(path: str, device="cuda") -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".png", ".jpg")):
        from ..frontend import jpeg, png  # noqa: PLC0415

        with open(path, "rb") as f:
            data = f.read()
        if path.endswith(".png"):
            img = png.decode_raw(data)
        else:
            coefs = jpeg.entropy_decode(data)
            img = jpeg.reconstruct(coefs, device).cpu().numpy()[..., :len(coefs.components)]
        if img.shape[2] == 1:
            return img[..., 0]
        return np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    raise ValueError("Invalid file format. Only .npy and .png are supported.")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path")
    ap.add_argument("--out", default=None,
                    help="save the colormapped PNG here instead of showing")
    ap.add_argument("--cmap", default="viridis")
    ap.add_argument("--device", default="cuda",
                    help="where a JPEG is reconstructed: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    depth = load_depth(args.path, args.device)
    if depth.ndim == 3:
        depth = depth[..., 0]

    import matplotlib  # noqa: PLC0415

    if args.out or not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt  # noqa: PLC0415

    plt.imshow(depth, cmap=args.cmap)
    plt.colorbar()
    plt.title("Depth Map")
    plt.axis("off")
    if args.out or not os.environ.get("DISPLAY"):
        out = args.out or os.path.splitext(args.path)[0] + "_viz.png"
        plt.savefig(out, bbox_inches="tight", dpi=120)
        plt.close()  # a later call in this process starts from a new figure
        print(f"wrote {out}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
