"""Export a trajectory + image index as a NeRF-style transforms.json (the
port's own copy of gslivm_tpu/tools/nerf_export.py; python/
parse_to_nerfslam.py parity: instant-ngp / nerf-slam dataset layout with
per-frame camera-to-world matrices and shared intrinsics).

Input is our native TUM pose file (utils/outputs.append_tum_pose) rather
than the reference's ad-hoc "name + 16 floats" rows; poses are
world-from-camera and are inverted to the camera-to-world convention the
NeRF tools expect (the reference does the same transpose/negate dance,
parse_to_nerfslam.py:13-20).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _quat_xyzw_to_R(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def export_transforms(tum_path: str, out_path: str, fx: float, fy: float,
                      cx: float, cy: float, width: int, height: int,
                      image_dir: str = "images",
                      invert: bool = False) -> dict:
    """Build the transforms.json dict and write it. `invert=True` when the
    pose file stores camera-from-world instead of world-from-camera."""
    from ..utils.trajectory import load_tum

    t, pos, quat = load_tum(tum_path)
    frames = []
    for i in range(len(t)):
        T = np.eye(4)
        T[:3, :3] = _quat_xyzw_to_R(quat[i])
        T[:3, 3] = pos[i]
        if invert:
            R = T[:3, :3].T
            T = np.block([[R, (-R @ T[:3, 3])[:, None]],
                          [np.zeros((1, 3)), np.ones((1, 1))]])
        frames.append({
            "file_path": f"{image_dir}/{i}",
            "depth_path": f"{image_dir}/{i}.depth.png",
            "transform_matrix": T.tolist(),
            "timestamp": float(t[i]),
        })
    store = {
        "fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy,
        "w": width, "h": height,
        "frames": frames,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(store, f, indent=4)
    return store


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tum_file")
    ap.add_argument("out_json")
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, required=True)
    ap.add_argument("--cx", type=float, required=True)
    ap.add_argument("--cy", type=float, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--invert", action="store_true")
    args = ap.parse_args(argv)
    store = export_transforms(args.tum_file, args.out_json, args.fx, args.fy,
                              args.cx, args.cy, args.width, args.height,
                              invert=args.invert)
    print(f"{len(store['frames'])} frames -> {args.out_json}")


if __name__ == "__main__":
    main()
