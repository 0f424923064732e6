#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card and hold its
hand-written CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

The serving path: a saved Gaussian map is loaded onto the card, three
1920x1080 views are rendered through the tile rasterizer (kernel K1,
`gslivm_tpu_torch/csrc/tile_forward.cu`) and each render is scored with
PSNR / SSIM / L1 (the SSIM blur is kernel K3, `csrc/blur.cu`). The map is
the repo's full-size benchmark scene (bench.py): 200,000 gaussians from
numpy.random.default_rng(0), in the JAX parameter layout, carried over with
`convert.params_from_numpy`, written with `save_ply` and read back with
`load_ply`.

Phases print one JSON line each: env, build, reference (K1's plain version
renders each view: the ground truth the views are scored against), serve
(the main path, with every kernel launch counter set to 0 just before it
and read just after), profile (torch.profiler over one served view: device
busy time, idle share, kernels by device time), k1_parity, k3_parity. Then
the card's name and power limit as nvidia-smi prints them, the kernels table
as one JSON line, and last {"ok": true, "device": {...}}. Any failure raises and exits non-zero;
without CUDA the script exits 1 and prints no result.

Tolerances: K1 against its plain version, rows C, D, A, T: max abs
deviation over max(|plain|, 1) per row <= 1e-3 (sequential compositing vs a
prefix product in f32); at most 0.1% of pixels may differ in n_contrib and
of tiles in neff (a rounding at the 1e-4 stop can move them). K3 against
the plain shift-add: max abs <= 1e-5 (f32 sums of 121 taps, FMA allowed).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
N_GAUSS = 200_000
VIEWS = ([0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0])  # bench.py:95, 200-203
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# flops per (instance, pixel) pair that K1 walks: dx, dy (2), the conic
# quadratic (9), exp (counted 2), alpha and its tests (2)
K1_FLOPS_PER_PAIR = 15


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_map():
    """The bench.py scene (bench.py:87-94) in the JAX parameter layout."""
    rng = np.random.default_rng(0)
    n = N_GAUSS
    means = rng.normal(0, 2.0, (n, 3)) + [0, 0, 6.0]
    scales = rng.uniform(0.01, 0.05, (n, 3))
    q = rng.normal(size=(n, 4))
    quats = q / np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,))
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3))
    return {
        "xyz": means.astype(np.float32),
        "features_dc": shs.astype(np.float32),
        "features_rest": np.zeros((n, 0, 3), np.float32),
        "scaling": np.log(scales).astype(np.float32),
        "rotation": quats.astype(np.float32),
        "opacity": np.log(opac / (1.0 - opac))[:, None].astype(np.float32),
        "n_active": np.int32(n),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gslivm_tpu_torch import convert, kernels
    from gslivm_tpu_torch.models import gaussian_model, training
    from gslivm_tpu_torch.models.cameras import make_camera
    from gslivm_tpu_torch.ops import blur, losses, rasterize_reference, rasterize_tiles
    from gslivm_tpu_torch.ops.binning import CHUNK
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
    from gslivm_tpu_torch.utils import metrics

    # ---- env ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- build: one nvcc per kernel source, in parallel --------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    usage = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas=usage)

    # ---- the map: JAX layout -> port -> PLY -> card ------------------------
    settings = RasterizeSettings()  # the mapper's defaults: auto -> tiles
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "map.ply")
        gaussian_model.save_ply(convert.params_from_numpy(make_map(), device="cpu"), ply)
        params = gaussian_model.load_ply(ply, device=dev)
    assert params.capacity == N_GAUSS and int(params.n_active) == N_GAUSS
    cams = [make_camera(np.eye(3), np.asarray(c), WIDTH, HEIGHT, fovx=1.2,
                        fovy=0.8, device=dev) for c in VIEWS]
    bg = torch.ones(3, device=dev)

    # ---- reference: K1's plain version on the same binned inputs ----------
    refs = []
    with torch.no_grad():
        for cam in cams:
            pre = rasterize_reference.preprocess(
                params.xyz, params.get_scaling(), params.get_rotation(),
                params.get_opacity()[:, 0], params.get_features(), cam,
                active_mask=params.active_mask())
            inst, binned, cfg = rasterize_tiles.prepare_tiles(
                pre, WIDTH, HEIGHT, max_instances=settings.max_instances,
                max_chunks_per_tile=settings.max_chunks_per_tile,
                capacity_slack=settings.capacity_slack,
                block_x=settings.block_x, block_y=settings.block_y,
                contrib_stats=settings.contrib_stats)
            args = (inst, binned.sorted_start, binned.tile_nchunks,
                    binned.cnt_allowed, cfg)
            plain = rasterize_tiles.composite_tiles_plain(*args)
            img = rasterize_tiles.tiles_to_image(plain, cfg)[:, :HEIGHT, :WIDTH]
            color = img[0:3] + img[5][None] * bg[:, None, None]
            refs.append(dict(args=args, plain=plain, color=color, binned=binned))
    torch.cuda.synchronize()
    emit("reference", views=len(refs),
         plain_color_mean=[float(r["color"].mean()) for r in refs])

    # ---- serve: the main path, launch counters around it -------------------
    rasterize_tiles.composite_tiles.launches = 0
    blur.blur_cuda.launches = 0
    renders, scores = [], []
    with torch.no_grad():
        for cam, ref in zip(cams, refs):
            out = training.render_params(params, cam, bg, settings)
            scores.append(metrics.image_pair_metrics(out.color, ref["color"]))
            renders.append(out)
    torch.cuda.synchronize()
    launches = {"K1": rasterize_tiles.composite_tiles.launches,
                "K3": blur.blur_cuda.launches}
    for out, s in zip(renders, scores):
        assert out.color.shape == (3, HEIGHT, WIDTH)
        assert bool(torch.isfinite(out.color).all() & torch.isfinite(out.depth).all())
        assert int(out.overflow) == 0, f"binning overflow {int(out.overflow)}"
        # the kernel render and the plain render of one view agree closely
        assert s["psnr"] > 60.0 and s["ssim"] > 0.9999, s
    assert launches["K1"] > 0 and launches["K3"] > 0, launches

    with torch.no_grad():
        render_ms = [cuda_ms(lambda c=c: training.render_params(params, c, bg, settings), 5)
                     for c in cams]
        eval_ms = cuda_ms(lambda: (losses.psnr(renders[0].color, refs[0]["color"]),
                                   losses.ssim(renders[0].color, refs[0]["color"])), 5)
    emit("serve", launches=launches, render_ms=render_ms, psnr_ssim_ms=eval_ms,
         views=[{"num_instances": int(o.num_instances), "max_nchunks": int(o.max_nchunks),
                 "walked_chunks": int(o.walked_chunks), "overflow": int(o.overflow),
                 **s} for o, s in zip(renders, scores)])

    # ---- profile: where one served view's device time goes -----------------
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = training.render_params(params, cams[0], bg, settings)
        metrics.image_pair_metrics(out.color, refs[0]["color"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_us = sorted(
        ((getattr(e, "self_device_time_total", 0), e.key, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_ms = sum(us for us, _, _ in kernels_us) / 1e3
    emit("profile", view=0, wall_ms=wall_ms, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / wall_ms,
         launches=sum(c for _, _, c in kernels_us),
         top=[{"kernel": k[:100], "device_ms": us / 1e3, "calls": c}
              for us, k, c in kernels_us[:12]])

    # ---- k1_parity: K1 vs its plain version, the same binned inputs --------
    k1_err, ncontrib_diff, neff_diff, pairs, inst_bytes = 0.0, 0, 0, 0, 0
    k1_ms, plain_ms = [], []
    with torch.no_grad():
        for out, ref in zip(renders, refs):
            args, plain = ref["args"], ref["plain"]
            cfg = args[-1]
            k = rasterize_tiles.composite_tiles(*args)
            # the main path rendered this same image
            img = rasterize_tiles.tiles_to_image(k, cfg)[:, :HEIGHT, :WIDTH]
            assert float((img[3] - out.depth).abs().max()) <= 1e-5 * max(
                float(out.depth.abs().max()), 1.0)
            for row in range(6):
                scale = max(float(plain[:, row].abs().max()), 1.0)
                k1_err = max(k1_err, float((k[:, row] - plain[:, row]).abs().max()) / scale)
            ncontrib_diff += int((k[:, 6] != plain[:, 6]).sum())
            neff_diff += int((k[:, 7, 0] != plain[:, 7, 0]).sum())
            # the (instance, pixel) pairs this run's data makes K1 walk
            b = ref["binned"]
            walked = torch.minimum(b.cnt_allowed.long(), k[:, 7, 0].long() * CHUNK)
            pairs += int(walked.sum()) * cfg.npix
            inst_bytes += int(walked.sum()) * 4 * rasterize_tiles.FEAT
            k1_ms.append(cuda_ms(lambda a=args: rasterize_tiles.composite_tiles(*a), 20))
            plain_ms.append(cuda_ms(lambda a=args: rasterize_tiles.composite_tiles_plain(*a), 3))
    n_views = len(renders)
    n_pix = n_views * cfg.num_tiles * cfg.npix
    n_tiles = n_views * cfg.num_tiles
    k1_flops = pairs * K1_FLOPS_PER_PAIR / n_views
    k1_bytes = (inst_bytes / n_views + cfg.num_tiles * 3 * 4
                + cfg.num_tiles * 8 * cfg.npix * 4)
    k1_bound = max(k1_flops / PEAK_F32, k1_bytes / PEAK_BYTES) * 1e3
    emit("k1_parity", max_scaled_err=k1_err, tol=1e-3,
         ncontrib_mismatch_pixels=ncontrib_diff, pixels=n_pix,
         neff_mismatch_tiles=neff_diff, tiles=n_tiles,
         kernel_ms=k1_ms, plain_ms=plain_ms, walked_pairs_per_view=pairs // n_views)
    assert k1_err <= 1e-3, k1_err
    assert ncontrib_diff <= 1e-3 * n_pix and neff_diff <= 1e-3 * n_tiles

    # ---- k3_parity: K3 on the SSIM stack of view 0 -------------------------
    taps = losses.gaussian_1d()
    a, b = renders[0].color, refs[0]["color"]
    stack = torch.cat([a, b, a * a, b * b, a * b]).contiguous()  # [15, H, W]
    with torch.no_grad():
        y = blur.blur_cuda(stack, taps)
        y_plain = blur.blur_plain(stack, taps)
        k3_err = float((y - y_plain).abs().max())
        g = torch.rand_like(stack)
        vjp_err = float((blur.blur_cuda(g, taps[::-1]) - blur.blur_plain(g, taps[::-1])).abs().max())
        k3_ms = cuda_ms(lambda: blur.blur_cuda(stack, taps), 20)
        k3_plain_ms = cuda_ms(lambda: blur.blur_plain(stack, taps), 5)
        # library yardstick: one cuDNN convolution in full f32 (never on the path)
        torch.backends.cudnn.allow_tf32 = False
        w2d = torch.as_tensor(np.outer(taps, taps), device=dev)[None, None]
        conv = torch.nn.functional.conv2d(stack[:, None], w2d, padding=len(taps) // 2)[:, 0]
        conv_err = float((conv - y_plain).abs().max())
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            stack[:, None], w2d, padding=len(taps) // 2), 20)
    n_el = stack.numel()
    k3_bytes = 2 * n_el * 4          # one read, one write per element
    k3_flops = n_el * 2 * 2 * len(taps)  # two passes of k multiply-adds
    k3_bound = max(k3_bytes / PEAK_BYTES, k3_flops / PEAK_F32) * 1e3
    emit("k3_parity", shape=list(stack.shape), max_abs_err=k3_err, vjp_max_abs_err=vjp_err,
         tol=1e-5, kernel_ms=k3_ms, plain_ms=k3_plain_ms, conv2d_ms=lib_ms,
         conv2d_max_abs_err=conv_err)
    assert k3_err <= 1e-5 and vjp_err <= 1e-5, (k3_err, vjp_err)

    # ---- the kernels table ---------------------------------------------------
    k1_bound_by = "operations" if k1_flops / PEAK_F32 >= k1_bytes / PEAK_BYTES else "bytes"
    k3_bound_by = "bytes" if k3_bytes / PEAK_BYTES >= k3_flops / PEAK_F32 else "operations"
    k1_mean, k1_plain_mean = float(np.mean(k1_ms)), float(np.mean(plain_ms))
    table = [
        {"name": "K1 tile_forward", "route": "cuda",
         "source": "gslivm_tpu_torch/csrc/tile_forward.cu",
         "replaces": "gslivm_tpu/ops/rasterize_pallas.py:298",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_mean, "plain_ms": k1_plain_mean,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "K3 blur", "route": "cuda", "source": "gslivm_tpu_torch/csrc/blur.cu",
         "replaces": "gslivm_tpu/ops/blur_pallas.py:34",
         "launches": launches["K3"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_bound_by, "library_ms": lib_ms},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
