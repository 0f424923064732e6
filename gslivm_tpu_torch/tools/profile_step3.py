"""Stage profile of the production-shape three-camera train step, with the
per-tile overdraw statistics (counterpart of tools/profile_step3.py).

The bench scene (200,000 gaussians from default_rng(0)), three 1920x1080
cameras, zero ground truth, `empty_simi(max_gauss=2048)` and the JAX tool's
tile budgets: max_instances 6700*128, capacity slack 0.2, supertile 2x2, 16
chunks per tile. It reports:

- overdraw: n_contrib per pixel (mean, p50, p90, p99, max) of one view and
  the chunks binned (sum of nchunks) against the chunks walked (sum of neff);
- stages: render3 (3x forward + backward, trivial loss), train1, train3
  without the history pair, train3 full, the three-camera image loss
  forward + backward separate against batched, and `delta_depth_loss`
  forward alone; each with its time by CUDA events (`ms`: the host's pace
  where the host holds the card back), the device time of its kernels
  (`busy_ms`, torch.profiler) and their count; and the differences
  image losses + Adam (train3 without the pair - render3) and the delta
  block (train3 - train3 without the pair).

The JAX tool also fits `RasterizeSettings.grad_capacity`, the TPU's
compacted gradient layout; K2 sums each walked instance's gradient into its
gaussian's column itself, so the port's settings have no such field and
this tool has no such step. Run on the card:

    python -m gslivm_tpu_torch.tools.profile_step3
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..models import training
from ..models.cameras import make_camera
from ..ops import losses
from ..ops.rasterize import RasterizeSettings, rasterize
from ..ops.rasterize_reference import preprocess
from ..ops.rasterize_tiles import render_tiles_raw
from ..utils.device import resolve_device
from .timing import device_busy_ms, device_time_ms

WIDTH, HEIGHT = 1920, 1080
N = 200_000
MAXI = 6700 * 128
BLOCK = (2, 2)
SLACK = 0.2
MAXCH = 16
LAMBDA_DSSIM = 0.2
SETTINGS = RasterizeSettings(max_instances=MAXI, max_chunks_per_tile=MAXCH,
                             capacity_slack=SLACK, block_x=BLOCK[0], block_y=BLOCK[1])


def make_scene(rng, device="cuda"):
    """(params, the three cameras), drawn as the JAX tool draws them."""
    n = N
    means = rng.normal(0, 2.0, (n, 3)) + [0, 0, 6.0]
    scales = rng.uniform(0.01, 0.05, (n, 3))
    q = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, (n,))
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3))
    params = convert.params_from_numpy({
        "xyz": means, "features_dc": shs, "features_rest": np.zeros((n, 0, 3)),
        "scaling": np.log(scales), "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "opacity": np.log(opac / (1.0 - opac))[:, None], "n_active": n}, device=device)
    cams = [make_camera(np.eye(3), np.asarray(c), WIDTH, HEIGHT, fovx=1.2, fovy=0.8,
                        device=device)
            for c in ([0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0])]
    return params, cams


def overdraw(params, cam) -> dict:
    """n_contrib statistics of one view and its binned vs walked chunks."""
    with torch.no_grad():
        out = rasterize(params.xyz, params.get_scaling(), params.get_rotation(),
                        params.get_opacity()[:, 0], params.get_features(), cam,
                        settings=SETTINGS._replace(backend="tiles", contrib_stats=True))
        pre = preprocess(params.xyz, params.get_scaling(), params.get_rotation(),
                         params.get_opacity()[:, 0], params.get_features(), cam)
        img, binned, cfg = render_tiles_raw(
            pre, cam.width, cam.height, max_instances=SETTINGS.max_instances,
            capacity_slack=SETTINGS.capacity_slack, block_x=SETTINGS.block_x,
            block_y=SETTINGS.block_y, max_chunks_per_tile=SETTINGS.max_chunks_per_tile,
            contrib_stats=False)
    ncon = out.n_contrib.double().cpu().numpy()
    nchunks = int(binned.tile_nchunks.long().sum())
    neff = int(img[7, ::cfg.ph, ::cfg.pw].double().sum())
    return {"n_contrib": {"mean": float(ncon.mean()),
                          **{f"p{q}": float(np.percentile(ncon, q)) for q in (50, 90, 99)},
                          "max": float(ncon.max())},
            "sum_nchunks": nchunks, "sum_neff": neff,
            "walked_fraction": neff / max(nchunks, 1), "overflow": int(out.overflow)}


def stages(params, cams, rng, reps: int = 5) -> dict:
    """Device ms of each stage of the step (see the module docstring)."""
    dev = params.xyz.device
    h, w = cams[0].height, cams[0].width
    gt = torch.zeros((3, h, w), device=dev)
    gt3 = torch.stack([gt, gt, gt])
    simi = training.empty_simi(max_gauss=2048, device=dev)
    optimizer = training.make_optimizer(params)
    leaves = [params.xyz, params.scaling, params.rotation, params.opacity,
              params.features_dc]

    def render3():
        tot = 0.0
        for c in cams:
            o = rasterize(params.xyz, params.get_scaling(), params.get_rotation(),
                          params.get_opacity(), params.get_features(), c, settings=SETTINGS)
            tot = tot + ((o.color - gt) ** 2).sum() + 0.1 * o.acc.sum()
        return torch.autograd.grad(tot, leaves)

    def step(n_cams, pairs):
        return training.train_step(params, optimizer, cams[:n_cams], gt3[:n_cams], simi,
                                   settings=SETTINGS, n_history_pairs=pairs)

    col3 = torch.as_tensor(rng.uniform(size=(3, 3, h, w)), dtype=torch.float32,
                           device=dev).requires_grad_(True)

    def loss_sep():
        loss = sum((1 - LAMBDA_DSSIM) * losses.l1_loss(col3[i], gt3[i])
                   + LAMBDA_DSSIM * (1.0 - losses.ssim(col3[i], gt3[i])) for i in range(3))
        return torch.autograd.grad(loss, col3)

    def loss_bat():
        flat, gflat = col3.reshape(9, h, w), gt3.reshape(9, h, w)
        l1 = (flat - gflat).abs().mean() * 3.0
        ss = losses.ssim(flat, gflat) * 3.0  # the channel mean is the mean per camera
        return torch.autograd.grad((1 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (3.0 - ss), col3)

    depth_a, depth_b = (torch.as_tensor(rng.uniform(1, 10, (h, w)), dtype=torch.float32,
                                        device=dev) for _ in range(2))
    acc = torch.ones((h, w), device=dev)

    def delta_fwd():
        with torch.no_grad():
            return training.delta_depth_loss(depth_a, acc, cams[1], depth_b, acc, cams[2])

    out = {}
    for name, fn in (("render3", render3), ("train1", lambda: step(1, 0)),
                     ("train3_no_pair", lambda: step(3, 0)), ("train3", lambda: step(3, 1)),
                     ("image_loss_separate", loss_sep), ("image_loss_batched", loss_bat),
                     ("delta_depth_fwd", delta_fwd)):
        busy = device_busy_ms(fn, reps=2, device=dev)
        out[name] = {"ms": device_time_ms(fn, reps=reps, device=dev),
                     "busy_ms": busy["device_busy_ms"], "kernels": busy["kernels_per_call"]}
    for name, (a, b) in (("image_losses_adam", ("train3_no_pair", "render3")),
                         ("delta_block", ("train3", "train3_no_pair"))):
        out[name] = {k: out[a][k] - out[b][k] for k in ("ms", "busy_ms", "kernels")}
    return out


def run(device="cuda", reps: int = 5) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params, cams = make_scene(rng, dev)
    return {"overdraw": overdraw(params, cams[0]), **stages(params, cams, rng, reps=reps)}


def main():
    res = run()
    od = res.pop("overdraw")
    nc = od["n_contrib"]
    print(f"n_contrib: mean {nc['mean']:.1f}  p50 {nc['p50']:.0f}  p90 {nc['p90']:.0f}"
          f"  p99 {nc['p99']:.0f}  max {nc['max']:.0f}")
    print(f"chunks: sum nchunks {od['sum_nchunks']}  sum neff {od['sum_neff']}"
          f"  (walked fraction {od['walked_fraction']:.3f})")
    for k, v in res.items():
        print(f"{k:20s} {v['ms']:9.3f} ms  device busy {v['busy_ms']:9.3f} ms  "
              f"{v['kernels']:7.0f} kernels", flush=True)


if __name__ == "__main__":
    main()
