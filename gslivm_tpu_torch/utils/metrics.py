"""Offline evaluation harness: PSNR / SSIM / depth-L1 over saved renders
(port of gslivm_tpu/utils/metrics.py).

Behavioral spec: reference python tooling (SURVEY §6):
  - python/evaluate_image.py:13-52 — split side-by-side images into
    render|GT halves, compute PSNR/SSIM (and LPIPS when the optional torch
    `lpips` package is available) and report means.
  - python/evaluate_no_split.py — the same over separate renders/ and gt/.
  - python/see_depth_l1.py:53-59 — inverse-depth L1 between depth images.

Images are [H, W, 3] uint8, [3, H, W] float in [0, 1], or tensors. The
math runs through the same loss ops as training (ops/losses.py): on the
card the SSIM blur is the K3 kernel. Tensor inputs stay on their device;
numpy inputs go to `device` ("cuda" unless the caller passes "cpu").
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from ..ops import losses as loss_ops
from .device import resolve_device


def load_png(path: str) -> np.ndarray:
    """Minimal PNG reader for RGB8 files (filters None, Sub and Up)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only RGB8 PNGs are supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    img = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.uint8)
    for i in range(h):
        row = raw[i * stride:(i + 1) * stride]
        filt, body = row[0], np.frombuffer(row[1:], np.uint8).copy()
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for j in range(3, len(body)):
                body[j] = (int(body[j]) + int(body[j - 3])) & 0xFF
        elif filt == 2:  # Up
            body = ((body.astype(np.int32) + prev) & 0xFF).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        img[i] = body.reshape(w, 3)
        prev = body
    return img


def _to_chw(img, device) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img.to(torch.float32)
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr.transpose(2, 0, 1).astype(np.float32) / (
            255.0 if arr.dtype == np.uint8 else 1.0)
    return torch.as_tensor(np.ascontiguousarray(arr, np.float32), device=device)


def _device_for(img, device):
    """The device the metrics run on: a tensor's own, else `device`."""
    if isinstance(img, torch.Tensor):
        return img.device
    return resolve_device(device)


_LPIPS_MODEL = None  # lazily constructed lpips net (or False if absent)


def lpips_pair(render_chw, gt_chw, required: bool = False):
    """LPIPS via the optional `lpips` package (the reference's offline metric
    triple is PSNR/SSIM/LPIPS, python/evaluate_image.py:7,30, with
    lpips.LPIPS(net='alex')). It needs the package's pretrained weights,
    so it is optional: returns None when `lpips` is not importable; with
    required=True it raises instead."""
    global _LPIPS_MODEL
    if _LPIPS_MODEL is None:
        try:
            import lpips as _lpips  # noqa: PLC0415

            _LPIPS_MODEL = _lpips.LPIPS(net="alex")
        except Exception:
            _LPIPS_MODEL = False
    if _LPIPS_MODEL is False:
        if required:
            raise RuntimeError(
                "LPIPS is unsupported in this environment: it requires the "
                "optional `lpips` torch package and its pretrained AlexNet "
                "weights. PSNR/SSIM/L1 remain available.")
        return None
    with torch.no_grad():
        # evaluate_image.py normalizes to [-1, 1]
        a = torch.as_tensor(np.asarray(render_chw, np.float32))[None] * 2 - 1
        b = torch.as_tensor(np.asarray(gt_chw, np.float32))[None] * 2 - 1
        return float(_LPIPS_MODEL(a, b).item())


def image_pair_metrics(render, gt, with_lpips: bool = False,
                       lpips_required: bool = False, device="cuda") -> dict:
    dev = _device_for(render, device)
    r, g = _to_chw(render, dev), _to_chw(gt, dev).to(dev)
    with torch.no_grad():
        out = {
            "psnr": float(loss_ops.psnr(r, g)),
            "ssim": float(loss_ops.ssim(r, g)),
            "l1": float(loss_ops.l1_loss(r, g)),
        }
    if with_lpips:
        out["lpips"] = lpips_pair(r.cpu().numpy(), g.cpu().numpy(),
                                  required=lpips_required)
    return out


def split_side_by_side(img: np.ndarray):
    """render|GT halves of a side-by-side image (evaluate_image.py:17-29)."""
    w = img.shape[1] // 2
    return img[:, :w], img[:, w:]


def _summarize(metrics_list: list[dict]) -> dict:
    n = len(metrics_list)
    lp = [m.get("lpips") for m in metrics_list]
    have_lpips = n > 0 and all(v is not None for v in lp)
    return {
        "count": n,
        "mean_psnr": float(np.mean([m["psnr"] for m in metrics_list])) if n else 0.0,
        "mean_ssim": float(np.mean([m["ssim"] for m in metrics_list])) if n else 0.0,
        "mean_l1": float(np.mean([m["l1"] for m in metrics_list])) if n else 0.0,
        # null when the optional lpips package is unavailable
        "mean_lpips": float(np.mean(lp)) if have_lpips else None,
    }


def evaluate_dir(path: str, lpips_required: bool = False, device="cuda") -> dict:
    """evaluate_image.py over a directory of side-by-side PNGs."""
    ms = []
    for name in sorted(os.listdir(path)):
        if not name.endswith(".png"):
            continue
        render, gt = split_side_by_side(load_png(os.path.join(path, name)))
        ms.append(image_pair_metrics(render, gt, with_lpips=True,
                                     lpips_required=lpips_required,
                                     device=device))
    return _summarize(ms)


def evaluate_dirs(render_dir: str, gt_dir: str, lpips_required: bool = False,
                  device="cuda") -> dict:
    """evaluate_no_split.py: metrics over separate renders/ and gt/ dirs,
    matched by sorted filename."""
    rs = sorted(n for n in os.listdir(render_dir) if n.endswith(".png"))
    gs = sorted(n for n in os.listdir(gt_dir) if n.endswith(".png"))
    ms = [image_pair_metrics(load_png(os.path.join(render_dir, rn)),
                             load_png(os.path.join(gt_dir, gn)),
                             with_lpips=True, lpips_required=lpips_required,
                             device=device)
          for rn, gn in zip(rs, gs)]
    return _summarize(ms)


def parse_log_time(path: str) -> dict:
    """Parse a log_time.txt dump (plot_all_time.py-compatible format,
    timer.cc:12-45): returns {'realtime_ms': float, 'sections': {name:
    [(stamp, ms), ...]}}."""
    with open(path) as f:
        lines = f.read().splitlines()
    realtime_ms = float(lines[0])
    names = [n.strip() for n in lines[1].split(",") if n.strip()]
    sections: dict[str, list] = {n: [] for n in names}
    for row in lines[2:]:
        cells = row.split(",")
        for name, cell in zip(names, cells):
            cell = cell.strip()
            if not cell:
                continue
            stamp, ms = cell.split("=")
            sections[name].append((float(stamp), float(ms)))
    return {"realtime_ms": realtime_ms, "sections": sections}


def inverse_depth_l1(depth_a, depth_b, epsilon: float = 1e-2,
                     device="cuda") -> float:
    """see_depth_l1.py:53-59: L1 between inverse depths."""
    dev = _device_for(depth_a, device)

    def t(d):
        return torch.as_tensor(d, dtype=torch.float32).to(dev)

    ia = loss_ops.inv_depth(t(depth_a), epsilon)
    ib = loss_ops.inv_depth(t(depth_b), epsilon)
    return float(torch.abs(ia - ib).mean())
