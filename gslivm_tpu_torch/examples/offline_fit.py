"""Offline map optimization benchmark (BASELINE.json config[1] shape; the
port's own copy of examples/offline_fit.py): N keyframes, GPR-initialized
map, offline 3DGS optimization at a fixed resolution; reports PSNR/SSIM
and training throughput.

Usage: python -m gslivm_tpu_torch.examples.offline_fit [--keyframes 20]
           [--iters 200] [--width 640] [--height 512] [--grid 0.1]
           [--device cuda|cpu]

The JAX example's flags and defaults; its --cpu is --device cpu here, the
default device is the card, and --backend takes auto|naive|tiles.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--grid", type=float, default=0.1)
    ap.add_argument("--points-per-frame", type=int, default=20000)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--max-instances", type=int, default=1 << 19)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gslivm_tpu_torch.config import Config, GpParams
    from gslivm_tpu_torch.frontend import synthetic
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
    from gslivm_tpu_torch.pipeline import IncrementalMapper
    from gslivm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = Config(gp=GpParams(grid=args.grid))
    frames = synthetic.make_sequence(
        n_frames=args.keyframes, width=args.width, height=args.height,
        points_per_frame=args.points_per_frame, device=dev)

    mapper = IncrementalMapper(
        config=cfg,
        settings=RasterizeSettings(backend=args.backend,
                                   max_instances=args.max_instances),
        bootstrap_points=500,
        initial_capacity=args.capacity,
        device=dev,
    )

    t0 = time.time()
    for fr in frames:
        stats = mapper.add_frame(fr)
    t_ingest = time.time() - t0
    print(f"ingest: {stats['active']} gaussians, "
          f"{stats['voxels']['converged']} voxels, "
          f"{len(mapper.cameras)} keyframes in {t_ingest:.1f}s "
          f"({t_ingest / max(len(frames), 1) * 1e3:.0f} ms/frame)")

    # warmup (builds the kernels on a card) one step
    m = mapper.train_iteration()
    sync()

    t0 = time.time()
    for _ in range(args.iters):
        m = mapper.train_iteration()
    sync()
    dt = time.time() - t0
    it_per_s = args.iters / dt
    print(f"training: {args.iters} iters in {dt:.2f}s = {it_per_s:.2f} it/s "
          f"({dt / args.iters * 1e3:.1f} ms/iter) at "
          f"{args.width}x{args.height}, loss {float(m.loss):.4f} "
          f"psnr {float(m.psnr):.2f}")

    e = mapper.evaluate()
    print(f"eval over keyframes: psnr {e['mean_psnr']:.2f} "
          f"ssim {e['mean_ssim']:.3f}")

    print(json.dumps({
        "metric": "offline_mapping_iters_per_s",
        "value": round(it_per_s, 2),
        "unit": "it/s",
        "resolution": f"{args.width}x{args.height}",
        "gaussians": stats["active"],
        "mean_psnr": round(e["mean_psnr"], 2),
        "device": str(dev),
    }))


if __name__ == "__main__":
    main()
