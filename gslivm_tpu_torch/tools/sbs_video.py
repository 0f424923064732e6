"""Side-by-side comparison video from two image folders (the port's own
copy of gslivm_tpu/tools/sbs_video.py; python/cat_image.py parity):
horizontally concatenate matching PNGs from two directories (e.g. renders
vs ground truth) into an mp4, with an optional frame offset between the
streams (the reference hard-codes a 6-frame shift, cat_image.py:41).

Frames are read by the port's PNG decoder (`frontend/png.py`); only the
mp4 writer is OpenCV's `VideoWriter`, imported when a video is written,
and the tool raises an ImportError that names it where OpenCV is absent
(as on the card machine).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _video_writer():
    try:
        import cv2  # noqa: PLC0415
    except ImportError as e:
        raise ImportError("sbs_video writes its mp4 with OpenCV's VideoWriter; cv2 is "
                          "not installed") from e
    return cv2


def _read(path: str) -> np.ndarray:
    """A PNG as [H, W, 3] uint8 BGR, as cv2.imread gives it."""
    from ..frontend import png  # noqa: PLC0415

    with open(path, "rb") as f:
        return np.ascontiguousarray(png.decode(f.read())[..., ::-1])


def make_video(dir_a: str, dir_b: str, out_path: str, fps: int = 10,
               offset: int = 0) -> int:
    def frames(d):
        names = [n for n in os.listdir(d) if n.endswith(".png")]

        def key(n):
            stem = os.path.splitext(n)[0]
            try:
                return (0, float(stem))
            except ValueError:
                return (1, stem)

        return [os.path.join(d, n) for n in sorted(names, key=key)]

    fa, fb = frames(dir_a), frames(dir_b)
    if offset >= 0:
        fa = fa[offset:]
    else:
        fb = fb[-offset:]
    n = min(len(fa), len(fb))
    if n == 0:
        return 0
    cv2 = _video_writer()
    a0 = _read(fa[0])
    b0 = _read(fb[0])
    size = (a0.shape[1] + b0.shape[1], max(a0.shape[0], b0.shape[0]))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, size)
    for pa, pb in zip(fa[:n], fb[:n]):
        a = _read(pa)
        b = _read(pb)
        canvas = np.zeros((size[1], size[0], 3), np.uint8)
        canvas[: a.shape[0], : a.shape[1]] = a
        canvas[: b.shape[0], a.shape[1]: a.shape[1] + b.shape[1]] = b
        writer.write(canvas)
    writer.release()
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--out", default="output.mp4")
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--offset", type=int, default=0)
    args = ap.parse_args(argv)
    print(make_video(args.dir_a, args.dir_b, args.out, args.fps,
                     args.offset), "frames")


if __name__ == "__main__":
    main()
