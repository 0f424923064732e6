"""Map-quality run of the incremental mapper at the botanic-garden shape
(port of tools/quality_bench.py).

The whole incremental pipeline (GP init, map growth, the three-camera
`train_iteration`s through the tile kernels) on the synthetic textured
room at 960x600 (botanic_garden.yaml's image size at ratio 0.5), with the
JAX tool's offline overrides: a prune every 100 iterations that also culls
runaway scales (> 0.5 m), and the position and scaling learning rates
log-lerped to their finals over --iters. It prints a sampled PSNR curve
(6 keyframes) with the scale statistics and overflow, then one JSON object
with the keys of QUALITY_r05.json: the final PSNR/SSIM over every keyframe
(`evaluate`, evaluate_image.py's methodology), each keyframe's PSNR, and
the inverse-depth L1 (see_depth_l1.py) against the exact ray-cast depth of
the scene, over the pixels where the render is opaque and the ground truth
hits a surface. The final PSNR must reach --psnr-floor.

    python -m gslivm_tpu_torch.tools.quality_bench [--iters 2000] [--out Q.json]
    python -m gslivm_tpu_torch.tools.quality_bench --cpu --width 48 --height 36 \\
        --keyframes 3 --points-per-frame 5000 --grid 0.5 --iters 4

On the card unless --cpu (there the naive renderer, a toy size only).
`run` returns the result and the run's bookkeeping (prunes, budget
refits and escalations, overflow and finiteness over every iteration);
`check_floor` is the floor.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..config import Config, GpParams, GsOptimParams
from ..frontend import synthetic
from ..ops.rasterize import RasterizeSettings
from ..pipeline import IncrementalMapper
from ..utils.device import device_name, resolve_device

CURVE_KEYFRAMES = 6


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--keyframes", type=int, default=30)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--points-per-frame", type=int, default=30000)
    ap.add_argument("--grid", type=float, default=0.12)
    ap.add_argument("--curve-every", type=int, default=50)
    ap.add_argument("--psnr-floor", type=float, default=25.0)
    ap.add_argument("--pos-lr-final", type=float, default=5e-5)
    ap.add_argument("--scale-lr-final", type=float, default=2.5e-4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    return ap


def make_config(args) -> Config:
    """The JAX tool's offline overrides: the max-scale prune (without it a
    few gaussians grow to tens of metres after ~700 iterations and occlude
    the scene) and the log-lerped position and scaling learning rates
    (constant rates keep the geometry swinging between per-camera fits)."""
    return Config(gp=GpParams(grid=args.grid),
                  gs=GsOptimParams(prune_interval=100, prune_max_scale=0.5,
                                   lr_max_steps=args.iters,
                                   position_lr_final=args.pos_lr_final,
                                   scaling_lr_final=args.scale_lr_final))


def keyframe_sample(n: int, k: int = CURVE_KEYFRAMES) -> list[int]:
    """k keyframe indices spread over n (repeats when n < k), as the JAX
    tool's curve and depth probes take them."""
    return [int(i) for i in np.linspace(0, n - 1, k).astype(int)]


def sampled_psnr(mapper: IncrementalMapper, indices) -> float:
    """Mean PSNR of the keyframes `indices` (repeats counted), each distinct
    keyframe scored once by score_keyframe, one host read."""
    uniq, counts = np.unique(indices, return_counts=True)
    vals = keyframe_scores(mapper, uniq)[:, 0]
    return float((vals * counts).sum() / counts.sum())


@torch.no_grad()
def scale_stats(mapper: IncrementalMapper) -> dict:
    """Mean, 99th percentile and max of the live gaussians' activated scales."""
    n = int(mapper.params.n_active)
    sc = torch.exp(mapper.params.scaling[:n]).double().cpu().numpy()
    return {"mean": float(sc.mean()), "p99": float(np.percentile(sc, 99)),
            "max": float(sc.max())}


def inverse_depth_l1(depth: np.ndarray, acc: np.ndarray, gt_depth: np.ndarray) -> float:
    """see_depth_l1.py's inverse-depth L1 over the pixels where the render
    is opaque (acc > 0.5) and the ground truth hits a surface."""
    mask = (acc > 0.5) & np.isfinite(gt_depth)
    inv_r = np.where(depth > 1e-2, 1.0 / np.maximum(depth, 1e-2), 0.0)
    inv_g = np.where(np.isfinite(gt_depth), 1.0 / np.maximum(gt_depth, 1e-2), 0.0)
    return float(np.abs(inv_r - inv_g)[mask].mean())


def depth_l1(mapper: IncrementalMapper, indices) -> float:
    """Mean inverse-depth L1 of the keyframes `indices` (repeats counted)
    against the scene's ray-cast depth (numpy on the host)."""
    planes = synthetic.default_scene()
    uniq, counts = np.unique(indices, return_counts=True)
    vals = []
    for i in uniq:
        out = mapper.render_keyframe(int(i))
        gt_d = synthetic.render_depth(mapper.cameras[int(i)], planes)
        vals.append(inverse_depth_l1(out.depth.cpu().numpy(), out.acc.cpu().numpy(), gt_d))
    return float((np.asarray(vals) * counts).sum() / counts.sum())


@torch.no_grad()
def keyframe_scores(mapper: IncrementalMapper, indices=None) -> np.ndarray:
    """[K, 3] score_keyframe (PSNR, SSIM, mean acc) of the keyframes
    `indices` (all by default), one host read. The column means of the
    first two over all keyframes are `evaluate()`'s."""
    if indices is None:
        indices = range(len(mapper.cameras))
    return torch.stack([mapper.score_keyframe(int(i)) for i in indices]).double().cpu().numpy()


def record_prunes(mapper: IncrementalMapper) -> list:
    """Wrap mapper.prune_map to log (iteration, dropped) of every prune."""
    log, prune = [], mapper.prune_map

    def recorded(*a, **k):
        dropped = prune(*a, **k)
        log.append((mapper.iter, dropped))
        return dropped

    mapper.prune_map = recorded
    return log


def make_mapper(args, device, *,
                initial_capacity: int = 1 << 17) -> tuple[IncrementalMapper, list]:
    """(the mapper, the synthetic frames) of the JAX tool's set-up."""
    frames = synthetic.make_sequence(n_frames=args.keyframes, width=args.width,
                                     height=args.height,
                                     points_per_frame=args.points_per_frame, device=device)
    mapper = IncrementalMapper(config=make_config(args),
                               settings=RasterizeSettings(max_instances=1 << 20),
                               bootstrap_points=500, initial_capacity=initial_capacity,
                               device=device)
    return mapper, frames


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, device=None, *, initial_capacity: int = 1 << 17,
        log=print) -> tuple[dict, dict]:
    """Ingest, train --iters iterations with the curve, score. Returns (the
    QUALITY_r05.json-keyed result, the run's bookkeeping: ingest seconds,
    the curve rows, prunes, refit and escalation events, the iterations
    that overflowed and whether every loss was finite, the final map size,
    budgets and the mapper itself)."""
    dev = resolve_device(device or ("cpu" if args.cpu else "cuda"))
    mapper, frames = make_mapper(args, dev, initial_capacity=initial_capacity)
    t0 = time.perf_counter()
    for fr in frames:
        stats = mapper.add_frame(fr)
    _sync(dev)
    t_ingest = time.perf_counter() - t0
    del frames
    log(f"ingest: {stats['active']} gaussians, {len(mapper.cameras)} keyframes, "
        f"{t_ingest:.1f}s")

    sample = keyframe_sample(len(mapper.cameras))
    prunes = record_prunes(mapper)
    rows = [{"iter": 0, "psnr": sampled_psnr(mapper, sample)}]
    log(f"iter 0: psnr {rows[0]['psnr']:.2f}")
    events = []
    # every iteration's overflow and finiteness, summed on the device
    overflowed = torch.zeros((), dtype=torch.int64, device=dev)
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    refits, escalations = mapper.budget_refits, mapper.overflow_escalations
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, args.iters + 1):
        m = mapper.train_iteration()
        overflowed += (m.overflow > 0).long()
        nonfinite += (~torch.isfinite(m.loss)).long()
        if (mapper.budget_refits, mapper.overflow_escalations) != (refits, escalations):
            kind = "refit" if mapper.budget_refits != refits else "escalation"
            events.append({"iter": i, "event": kind,
                           "max_instances": mapper.settings.max_instances,
                           "max_chunks_per_tile": mapper.settings.max_chunks_per_tile})
            refits, escalations = mapper.budget_refits, mapper.overflow_escalations
        if i % args.curve_every == 0:
            p = sampled_psnr(mapper, sample)
            sc = scale_stats(mapper)
            row = {"iter": i, "psnr": p, "loss": float(m.loss),
                   "image_loss": float(m.image_loss), "simi": float(m.simi),
                   "delta": float(m.delta), "scale": sc, "overflow": int(m.overflow),
                   "gaussians": int(mapper.params.n_active)}
            rows.append(row)
            log(f"iter {i}: psnr {p:.2f} loss {row['loss']:.4f} "
                f"(img {row['image_loss']:.4f} simi {row['simi']:.4f} "
                f"delta {row['delta']:.4f}) scale mean {sc['mean']:.4f} p99 "
                f"{sc['p99']:.3f} max {sc['max']:.3f} overflow {row['overflow']}")
    _sync(dev)
    t_train = time.perf_counter() - t0

    scores = keyframe_scores(mapper)
    mean_psnr, mean_ssim = (float(v) for v in scores[:, :2].mean(axis=0))
    per_kf = [round(float(p), 2) for p in scores[:, 0]]
    log("per-keyframe PSNR: " + " ".join(f"{v:.1f}" for v in per_kf))
    dl1 = depth_l1(mapper, sample)

    result = {
        "metric": "quality_synthetic_960x600",
        "final_psnr": round(mean_psnr, 2),
        "final_ssim": round(mean_ssim, 4),
        "depth_l1_inv": round(dl1, 5),
        "psnr_curve": [[r["iter"], round(r["psnr"], 2)] for r in rows],
        "per_keyframe_psnr": per_kf,
        "min_keyframe_psnr": min(per_kf) if per_kf else 0.0,
        "iters": args.iters,
        "train_s": round(t_train, 1),
        "iters_per_s": round(args.iters / t_train, 2),
        "gaussians": int(stats["active"]),
        "keyframes": len(mapper.cameras),
        "resolution": f"{args.width}x{args.height}",
        "device": device_name(dev),
        "psnr_floor": args.psnr_floor,
    }
    info = {"ingest_s": t_ingest, "train_s": t_train, "mean_psnr": mean_psnr,
            "mean_ssim": mean_ssim, "depth_l1_inv": dl1, "curve": rows,
            "prunes": prunes, "budget_events": events,
            "budget_refits": mapper.budget_refits,
            "overflow_escalations": mapper.overflow_escalations,
            "overflowed_iters": int(overflowed), "nonfinite_losses": int(nonfinite),
            "gaussians_final": int(mapper.params.n_active),
            "capacity": mapper.params.capacity,
            "settings": {"max_instances": mapper.settings.max_instances,
                         "max_chunks_per_tile": mapper.settings.max_chunks_per_tile},
            "mapper": mapper}
    return result, info


def check_floor(result: dict):
    """The JAX tool's pinned floor on the final PSNR."""
    if not result["final_psnr"] >= result["psnr_floor"]:
        raise AssertionError(f"final PSNR {result['final_psnr']:.2f} dB below pinned "
                             f"floor {result['psnr_floor']}")


def main(argv=None, **kw):
    """CLI; keywords go to `run` (a test passes a smaller capacity)."""
    args = build_argparser().parse_args(argv)
    result, _ = run(args, **kw)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    check_floor(result)
    return result


if __name__ == "__main__":
    main()
