"""Stage profile of IncrementalMapper.add_frame, the gsPointCloudUpdate
analog (port of tools/profile_ingest.py).

Each frame's wall time (host clock, the card synchronised after the
frame), split by the mapper's own `ingest_seconds`:

  divide    GpMap.divide_points (host voxel bookkeeping + PCA)
  gp        gp3d.gp_forward, the one read of its outputs and the loss-anchor
            and colour-pool bookkeeping (the JAX tool's "gp" wraps only the
            gp_forward dispatch: its read lands in "other")
  other     the rest of the frame: colorize (deferred-pool colourisation and
            its read), append (capacity growth, append_points, registry),
            stage (keyframe GT and SSIM statistics) and the untimed
            remainder, each also printed on its own

    python -m gslivm_tpu_torch.tools.profile_ingest [--frames 10]
    python -m gslivm_tpu_torch.tools.profile_ingest --cpu --frames 3 --width 48 --height 36

On the card unless --cpu.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import Config, GpParams
from ..frontend import synthetic
from ..ops.rasterize import RasterizeSettings
from ..pipeline import IncrementalMapper
from ..utils.device import device_name, resolve_device

STAGES = ("divide", "gp", "colorize", "append", "stage")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--points-per-frame", type=int, default=30000)
    ap.add_argument("--grid", type=float, default=0.12)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, device=None, log=print) -> dict:
    """Ingest --frames frames. Returns the scene's seconds, each frame's ms
    and stats, the JAX tool's split (divide, gp, other, total seconds) and
    the five stages plus the untimed remainder, which sum to the total."""
    dev = resolve_device(device or ("cpu" if args.cpu else "cuda"))
    t0 = time.perf_counter()
    frames = synthetic.make_sequence(n_frames=args.frames, width=args.width,
                                     height=args.height,
                                     points_per_frame=args.points_per_frame, device=dev)
    scene_s = time.perf_counter() - t0
    log(f"scene gen: {scene_s:.1f}s")
    mapper = IncrementalMapper(config=Config(gp=GpParams(grid=args.grid)),
                               settings=RasterizeSettings(), bootstrap_points=500,
                               initial_capacity=1 << 17, device=dev)
    stages = dict.fromkeys(STAGES, 0.0)
    per_frame = []
    for i, fr in enumerate(frames):
        t = time.perf_counter()
        stats = mapper.add_frame(fr)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t
        for k in STAGES:
            stages[k] += mapper.ingest_seconds[k]
        per_frame.append({"ms": dt * 1e3, "inserted": stats["inserted"],
                          "pending": stats["pending_color"], "active": stats["active"]})
        log(f"frame {i}: {dt * 1e3:.0f} ms  inserted {stats['inserted']} "
            f"pending {stats['pending_color']} active {stats['active']}")
    total = sum(f["ms"] for f in per_frame) / 1e3
    split = {"divide": stages["divide"], "gp": stages["gp"],
             "other": total - stages["divide"] - stages["gp"], "total": total}
    log({k: round(v, 2) for k, v in split.items()})
    return {"device": device_name(dev),
            "scene_s": scene_s, "frames": per_frame, "split": split,
            "stages": {**stages, "untimed": total - sum(stages.values())}}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
