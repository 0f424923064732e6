"""Where does the incremental mapper's `train_iteration` time go? (port of
tools/profile_iteration.py.)

quality_bench's mapper (960x600, 30 keyframes, no prune) is ingested, takes
60 warm-up iterations (the budget fit settles), then four stages run:

  A   a bare launch and synchronise of one tiny op (20 round trips), and
      A2, 100 chained launches with one synchronise: the launch cost
  B   the pre-staged one-camera `train_step` back to back (a copy of the
      mapper's map and Adam state, so the mapper is not moved): the step
  D   the per-iteration input assembly alone (sampling, GT and SSIM
      statistics stacks, simi inputs): host and launch cost
  C   `train_iteration` itself: the whole

Each stage is timed by CUDA events around --iters calls (per call: the
host's pace where the host holds the card back) and, beside it, the device
time of its kernels and their count (torch.profiler over 3 calls,
`timing.device_busy_ms`). The JAX tool's settings line also prints
`grad_capacity`, the TPU's compacted gradient layout; the port's K2 sums
each instance's gradient into its gaussian itself, so its settings have no
such field. Times need a card: --cpu is refused.

    python -m gslivm_tpu_torch.tools.profile_iteration [--iters 50]
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from ..config import Config, GpParams, GsOptimParams
from ..frontend import synthetic
from ..models import training
from ..ops.rasterize import RasterizeSettings
from ..pipeline import IncrementalMapper
from .timing import cuda_device, device_busy_ms, device_time_ms

WARMUP = 60


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--keyframes", type=int, default=30)
    ap.add_argument("--points-per-frame", type=int, default=30000)
    ap.add_argument("--grid", type=float, default=0.12)
    ap.add_argument("--cpu", action="store_true")
    return ap


def staged_step(mapper: IncrementalMapper, cam_idx=(0,)):
    """A callable taking one train_step on keyframes `cam_idx` from a COPY
    of the mapper's map and Adam state, with the inputs staged once."""
    params, optimizer = copy.deepcopy((mapper.params, mapper.optimizer))
    cams = [mapper.cameras[i] for i in cam_idx]
    gts = torch.stack([mapper._gt_device[i] for i in cam_idx])
    stats = (torch.stack([mapper._gt_stats[i][0] for i in cam_idx]),
             torch.stack([mapper._gt_stats[i][1] for i in cam_idx]))
    simi = mapper._simi_inputs()

    def step():
        return training.train_step(params, optimizer, cams, gts, simi,
                                   opt_params=mapper.cfg.gs, settings=mapper.settings,
                                   bg_color=mapper._bg, gt_stats=stats)
    return step


def assemble_inputs(mapper: IncrementalMapper):
    """What train_iteration does around the step: sample, stack the GT
    images and their SSIM statistics, take the simi inputs."""
    curr, hist = mapper._sample_cameras()
    ci = curr + [i for pair in hist for i in pair]
    _ = [mapper.cameras[i] for i in ci]
    g = torch.stack([mapper._gt_device[i] for i in ci])
    s = (torch.stack([mapper._gt_stats[i][0] for i in ci]),
         torch.stack([mapper._gt_stats[i][1] for i in ci]))
    return g, s, mapper._simi_inputs()


def run(args, device="cuda", log=print) -> dict:
    """Set up, warm up, time stages A, A2, B, D and C. Returns the settings
    after the fit and each stage's ms per call with its device busy ms and
    kernels per call."""
    dev = cuda_device(device)
    cfg = Config(gp=GpParams(grid=args.grid), gs=GsOptimParams(prune_interval=0))
    frames = synthetic.make_sequence(n_frames=args.keyframes, width=args.width,
                                     height=args.height,
                                     points_per_frame=args.points_per_frame, device=dev)
    mapper = IncrementalMapper(config=cfg, settings=RasterizeSettings(max_instances=1 << 21),
                               bootstrap_points=500, initial_capacity=1 << 17, device=dev)
    t0 = time.perf_counter()
    for fr in frames:
        mapper.add_frame(fr)
    torch.cuda.synchronize(dev)
    ingest_s = time.perf_counter() - t0
    del frames
    log(f"ingest {ingest_s:.0f}s  n={int(mapper.params.n_active)}")

    for _ in range(WARMUP):
        mapper.train_iteration()
    torch.cuda.synchronize(dev)
    settings = {"max_instances": mapper.settings.max_instances,
                "chunks": mapper.settings.max_chunks_per_tile,
                "refits": mapper.budget_refits, "escalations": mapper.overflow_escalations}
    log(f"settings after fit: max_instances={settings['max_instances']}"
        f" chunks={settings['chunks']} refits={settings['refits']}")

    x = torch.zeros(8, device=dev)

    def bare():
        (x + 1.0)
        torch.cuda.synchronize(dev)

    def chained():
        y = x
        for _ in range(100):
            y = y + 1.0
        return y

    step = staged_step(mapper)
    stages = {}
    for key, fn, reps, per in (("A", bare, 20, 1), ("A2", chained, 1, 100),
                               ("B", step, args.iters, 1),
                               ("D", lambda: assemble_inputs(mapper), args.iters, 1),
                               ("C", mapper.train_iteration, args.iters, 1)):
        ms = device_time_ms(fn, reps=reps, device=dev) / per
        busy = device_busy_ms(fn, reps=3, device=dev)
        stages[key] = {"ms": ms, "busy_ms": busy["device_busy_ms"] / per,
                       "kernels": busy["kernels_per_call"] / per}
    log(f"A bare launch+sync: {stages['A']['ms']:.3f} ms")
    log(f"A2 async launch (100 chained, 1 sync): {stages['A2']['ms']:.4f} ms/op")
    log(f"B pre-staged train_step: {stages['B']['ms']:.1f} ms "
        f"(device busy {stages['B']['busy_ms']:.2f} ms)")
    log(f"D input assembly: {stages['D']['ms']:.2f} ms "
        f"(device busy {stages['D']['busy_ms']:.3f} ms)")
    log(f"C train_iteration: {stages['C']['ms']:.1f} ms ({1e3 / stages['C']['ms']:.1f} "
        f"iters/s; device busy {stages['C']['busy_ms']:.2f} ms)")
    return {"device": torch.cuda.get_device_name(dev), "ingest_s": ingest_s,
            "gaussians": int(mapper.params.n_active), "settings": settings,
            "iters": args.iters, "stages": stages}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
