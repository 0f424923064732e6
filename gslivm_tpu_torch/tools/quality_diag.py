"""Map-quality diagnosis at quality_bench's scene and configuration (port of
tools/quality_diag.py): where does a PSNR plateau come from?

  init      ingest only: each keyframe's PSNR of the freshly GP-initialised
            map (bounds the colourisation and initialisation), error maps.
  pipeline  quality_bench's flow with every keyframe's PSNR, learning-rate
            overrides and error maps of the worst, median and best views.
  oracle    the ceiling: no GP front end; splats planted on a regular grid
            over the exact scene surfaces with their exact texture colours,
            then optimised. If the oracle cannot pass the floor, density or
            representation limits the map, not the front end.

    python -m gslivm_tpu_torch.tools.quality_diag init     [--grid 0.12]
    python -m gslivm_tpu_torch.tools.quality_diag pipeline [--iters 800] [--feature-lr 0.004]
    python -m gslivm_tpu_torch.tools.quality_diag oracle   [--spacing 0.05] [--iters 1000]

On the card unless --cpu (a toy size only). --dump-dir writes each probed
view's side-by-side and error-map PNGs; --out the JSON of the result.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import Config, GpParams, GsOptimParams
from ..frontend import synthetic
from ..models import gaussian_model as gm
from ..models import training
from ..ops import losses as loss_ops
from ..ops.rasterize import RasterizeSettings
from ..pipeline import IncrementalMapper
from ..utils.device import device_name, resolve_device
from ..utils.outputs import save_png
from .quality_bench import keyframe_scores, scale_stats


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["init", "pipeline", "oracle"])
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--keyframes", type=int, default=30)
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--points-per-frame", type=int, default=30000)
    ap.add_argument("--grid", type=float, default=0.12)
    ap.add_argument("--curve-every", type=int, default=100)
    ap.add_argument("--feature-lr", type=float, default=None)
    ap.add_argument("--position-lr", type=float, default=None)
    ap.add_argument("--opacity-lr", type=float, default=None)
    ap.add_argument("--pos-lr-final", type=float, default=5e-5)
    ap.add_argument("--scale-lr-final", type=float, default=2.5e-4)
    ap.add_argument("--no-decay", action="store_true")
    ap.add_argument("--spacing", type=float, default=0.05,
                    help="oracle splat grid spacing (m)")
    ap.add_argument("--cov-frac", type=float, default=0.5,
                    help="oracle cov sigma as a fraction of spacing (pre "
                         "scale_factor-3 inflation)")
    ap.add_argument("--dump-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    return ap


def gs_overrides(args) -> dict:
    """The GsOptimParams overrides of the JAX tool, by flag."""
    over = dict(prune_interval=100, prune_max_scale=0.5)
    if not args.no_decay:
        over.update(lr_max_steps=args.iters, position_lr_final=args.pos_lr_final,
                    scaling_lr_final=args.scale_lr_final)
    if args.feature_lr is not None:
        over["feature_lr"] = args.feature_lr
    if args.position_lr is not None:
        over["position_lr_init"] = args.position_lr
    if args.opacity_lr is not None:
        over["opacity_lr"] = args.opacity_lr
    return over


def oracle_points(spacing: float, cov_frac: float):
    """(xyz [M, 3], rgb [M, 3] in 0..255, cov [M, 3, 3]) float32: a regular
    grid of `spacing` over each plane of the scene with its exact texture
    colour, isotropic sigma = spacing * cov_frac."""
    pts, cols = [], []
    for pid, pl in enumerate(synthetic.default_scene()):
        n = max(2, int(round(2 * pl.extent / spacing)))
        u = np.linspace(-pl.extent + spacing / 2, pl.extent - spacing / 2, n)
        uu, vv = np.meshgrid(u, u, indexing="ij")
        v_axis = np.cross(pl.normal, pl.u_axis)
        xyz = (pl.point[None, None] + uu[..., None] * pl.u_axis[None, None]
               + vv[..., None] * v_axis[None, None])
        pts.append(xyz.reshape(-1, 3))
        cols.append(synthetic._texture(pid, uu, vv).reshape(-1, 3) * 255.0)
    xyz = np.concatenate(pts).astype(np.float32)
    rgb = np.concatenate(cols).astype(np.float32)
    sig = spacing * cov_frac
    cov = np.broadcast_to(np.eye(3) * sig * sig, (xyz.shape[0], 3, 3)).astype(np.float32)
    return xyz, rgb, cov


def stage_oracle(mapper: IncrementalMapper, frames, args, log=print) -> int:
    """Plant the oracle splats as the map (capacity: the next power of two
    above their count) with a fresh optimizer over it, and stage every
    frame's camera as a keyframe as add_frame does (the ground truth on the
    device and its SSIM statistics); the loss anchors stay empty. Returns
    the splat count."""
    dev = mapper.device
    xyz, rgb, cov = oracle_points(args.spacing, args.cov_frac)
    m = xyz.shape[0]
    cap = 1 << int(np.ceil(np.log2(m + 1)))
    batch = gm.PointBatch(xyz=torch.from_numpy(xyz).to(dev), rgb=torch.from_numpy(rgb).to(dev),
                          cov=torch.from_numpy(np.ascontiguousarray(cov)).to(dev),
                          mask=torch.ones(m, dtype=torch.bool, device=dev))
    mapper.params = gm.create_from_points(batch, mapper.cfg.gs.scale_factor, cap,
                                          mapper.cfg.model.sh_degree)
    mapper.optimizer = training.make_optimizer(mapper.params, mapper.cfg.gs)
    mapper.started = True
    for fr in frames:
        mapper.cameras.append(fr.camera)
        gt = np.asarray(fr.image, np.float32).transpose(2, 0, 1) / 255.0
        mapper.gt_images.append(gt)
        gt_dev = torch.from_numpy(gt).to(dev)
        mapper._gt_device.append(gt_dev)
        with torch.no_grad():
            mapper._gt_stats.append(loss_ops.ssim_ref_stats(gt_dev))
    mapper._simi_cache = None
    log(f"oracle: {m} splats at spacing {args.spacing} "
        f"(sigma {args.spacing * args.cov_frac:.3f})")
    return m


@torch.no_grad()
def per_keyframe(mapper: IncrementalMapper) -> list[dict]:
    """Every keyframe's PSNR, SSIM and mean acc (one host read)."""
    return [{"kf": i, "psnr": float(p), "ssim": float(s), "mean_acc": float(a)}
            for i, (p, s, a) in enumerate(keyframe_scores(mapper))]


def report(tag: str, rows, log=print) -> np.ndarray:
    ps = np.array([r["psnr"] for r in rows])
    log(f"[{tag}] mean_psnr {ps.mean():.2f}  min {ps.min():.2f} (kf {int(ps.argmin())})  "
        f"max {ps.max():.2f} (kf {int(ps.argmax())})  std {ps.std():.2f}")
    log("  " + " ".join(f"{r['psnr']:.1f}" for r in rows))
    return ps


def top_share(err: np.ndarray, frac: float = 0.01) -> float:
    """The share of the squared error held by its largest `frac` pixels."""
    sq = np.sort((err ** 2).ravel())[::-1]
    k = max(1, int(len(sq) * frac))
    return float(sq[:k].sum() / max(sq.sum(), 1e-12))


@torch.no_grad()
def dump(mapper: IncrementalMapper, dump_dir, tag: str, indices, log=print) -> list[dict]:
    """Side-by-side and error-map PNGs (|err| saturating at 0.25) of the
    keyframes `indices`; returns their error statistics."""
    if not dump_dir:
        return []
    os.makedirs(dump_dir, exist_ok=True)
    stats = []
    for i in indices:
        r = mapper.render_keyframe(int(i)).color.cpu().numpy().transpose(1, 2, 0)
        g = mapper.gt_images[int(i)].transpose(1, 2, 0)
        err = np.abs(r - g).mean(-1)
        sbs = np.concatenate([r, g], axis=1)
        save_png(os.path.join(dump_dir, f"{tag}_kf{i:02d}_sbs.png"),
                 (np.clip(sbs, 0, 1) * 255).astype(np.uint8))
        emap = np.clip(err / 0.25, 0, 1)
        save_png(os.path.join(dump_dir, f"{tag}_kf{i:02d}_err.png"),
                 (np.stack([emap] * 3, -1) * 255).astype(np.uint8))
        st = {"kf": int(i), "mean_err": float(err.mean()),
              "p99_err": float(np.percentile(err, 99)), "top1_share": top_share(err)}
        stats.append(st)
        log(f"  dumped kf {i}: mean|err| {st['mean_err']:.4f}, p99 {st['p99_err']:.3f}, "
            f"top1% share of sq err {st['top1_share']:.2f}")
    return stats


def run(args, device=None, *, initial_capacity: int = 1 << 17,
        log=print) -> tuple[dict, IncrementalMapper]:
    """One probe (args.mode). Returns the JAX tool's result dict (mode,
    init_psnr, gaussians, config, grid; with training: final_psnr,
    psnr_curve, iters, train_s, iters_per_s), plus `setup_s`, `device` and
    the dumps' error statistics; and the mapper."""
    dev = resolve_device(device or ("cpu" if args.cpu else "cuda"))
    over = gs_overrides(args)
    cfg = Config(gp=GpParams(grid=args.grid), gs=GsOptimParams(**over))
    frames = synthetic.make_sequence(n_frames=args.keyframes, width=args.width,
                                     height=args.height,
                                     points_per_frame=args.points_per_frame, device=dev)
    mapper = IncrementalMapper(config=cfg,
                               settings=RasterizeSettings(max_instances=1 << 21),
                               bootstrap_points=500, initial_capacity=initial_capacity,
                               device=dev)
    t0 = time.perf_counter()
    if args.mode == "oracle":
        stage_oracle(mapper, frames, args, log)
    else:
        for fr in frames:
            mapper.add_frame(fr)
    del frames
    setup_s = time.perf_counter() - t0
    log(f"setup: {int(mapper.params.n_active)} gaussians, {len(mapper.cameras)} "
        f"keyframes, {setup_s:.1f}s")

    def probe(rows):
        return [int(np.argmin([r["psnr"] for r in rows])), len(rows) // 2,
                int(np.argmax([r["psnr"] for r in rows]))]

    rows0 = per_keyframe(mapper)
    report("init" if args.mode != "oracle" else "oracle-init", rows0, log)
    dumps = {"init": dump(mapper, args.dump_dir, "init", probe(rows0), log)}
    result = {"mode": args.mode, "init_psnr": rows0,
              "gaussians": int(mapper.params.n_active), "config": over,
              "grid": args.grid}

    if args.mode != "init":
        curve = []
        t0 = time.perf_counter()
        for i in range(1, args.iters + 1):
            m = mapper.train_iteration()
            if i % args.curve_every == 0:
                ev = mapper.evaluate()
                sc = scale_stats(mapper)
                curve.append((i, round(ev["mean_psnr"], 2)))
                log(f"iter {i}: psnr {ev['mean_psnr']:.2f} ssim {ev['mean_ssim']:.4f} "
                    f"loss {float(m.loss):.4f} scale p99 {sc['p99']:.3f} "
                    f"max {sc['max']:.2f} n {int(mapper.params.n_active)}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_train = time.perf_counter() - t0
        rows1 = per_keyframe(mapper)
        report("final", rows1, log)
        dumps["final"] = dump(mapper, args.dump_dir, "final", probe(rows1), log)
        result.update(final_psnr=rows1, psnr_curve=curve, iters=args.iters,
                      train_s=round(t_train, 1), iters_per_s=round(args.iters / t_train, 2))
    result.update(setup_s=setup_s, device=device_name(dev), dumps=dumps)
    return result, mapper


def main(argv=None, **kw):
    """CLI; keywords go to `run` (a test passes a smaller capacity)."""
    args = build_argparser().parse_args(argv)
    result, _ = run(args, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("DONE", flush=True)
    return result


if __name__ == "__main__":
    main()
