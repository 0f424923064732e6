"""Rosbag extraction (the port's own copy of gslivm_tpu/tools/bag_export.py:
python/parse_pose.py + extract_image.py + listen_odom.py offline parity),
built on the ROS-free reader frontend/rosbag.py; host code, but for the
reconstruction of JPEG CompressedImages on --device.

    python -m gslivm_tpu_torch.tools.bag_export poses BAG --topic /gt --out gt.txt
        PoseStamped/Odometry -> TUM rows
    python -m gslivm_tpu_torch.tools.bag_export images BAG --topic /cam --out rgb/
        Image/CompressedImage -> <stamp>.png + an rgb.txt index (TUM style)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..frontend import rosbag as rb
from ..utils.outputs import append_tum_pose, save_png


def extract_poses(bag_path: str, topic: str, out_path: str) -> int:
    """Write every pose message on `topic` as a TUM row (parse_pose.py:20-28),
    stamped by its header, or by the bag record when the header is 0."""
    if os.path.exists(out_path):
        os.remove(out_path)
    n = 0
    for msg in rb.read_bag(bag_path, {topic}):
        rec = rb.decode(msg)
        if isinstance(rec, rb.PoseSample):
            append_tum_pose(out_path, rec.t if rec.t > 0 else msg.t, rec.position,
                            rec.quat_xyzw)
            n += 1
    return n


def extract_images(bag_path: str, topic: str, out_dir: str,
                   index_path: str | None = None, device="cuda") -> int:
    """Save every image on `topic` as <stamp>.png plus a `stamp dir/<name>`
    index (extract_image.py:8-48); JPEGs are reconstructed on `device`."""
    os.makedirs(out_dir, exist_ok=True)
    if index_path is None:
        index_path = os.path.join(out_dir, os.pardir, "rgb.txt")
    if os.path.exists(index_path):
        os.remove(index_path)
    n = 0
    with open(index_path, "a") as idx:
        for msg in rb.read_bag(bag_path, {topic}):
            rec = rb.decode(msg, device=device)
            if rec is None or not hasattr(rec, "image"):
                continue
            name = f"{rec.t:.6f}.png"
            img = np.asarray(rec.image)
            if img.dtype != np.uint8:
                img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            save_png(os.path.join(out_dir, name), img)
            idx.write(f"{rec.t:.6f} {os.path.basename(out_dir)}/{name}\n")
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("poses")
    p.add_argument("bag")
    p.add_argument("--topic", required=True)
    p.add_argument("--out", required=True)
    p = sub.add_parser("images")
    p.add_argument("bag")
    p.add_argument("--topic", required=True)
    p.add_argument("--out", default="rgb")
    p.add_argument("--index", default=None)
    p.add_argument("--device", default="cuda",
                   help="where JPEG images are reconstructed: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd == "poses":
        print(extract_poses(args.bag, args.topic, args.out), "poses")
    else:
        print(extract_images(args.bag, args.topic, args.out, args.index, args.device),
              "images")


if __name__ == "__main__":
    main()
