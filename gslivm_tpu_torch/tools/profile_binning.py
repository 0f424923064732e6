"""Cumulative-prefix profile inside bin_instances on the 1080p bench scene
(port of tools/profile_binning.py and tools/profile_binning2.py, merged).

The bench scene (`exp_block.bench_scene`) preprocessed once, binned at
profile_binning2's budgets (max_instances 6700*128, 16 chunks a tile,
capacity slack 0.2, supertile 2x2). The cuts mirror the port's own
`ops/binning.py:bin_instances` (sorted layout, ellipse cull on, no band),
each a prefix of the one after it; a stage's cost is the difference
between consecutive rows:

  argsort+gtab permute   the depth argsort and the rect/valid gathers into
                         rank order
  + counts/offsets       the supertile cover, instances per gaussian, their
                         exclusive prefix sum
  + expansion gid        each slot's gaussian by searchsorted
  + meta gather          the per-slot gathers: rect, offset, the cull's
                         screen features
  + tileid & cull        each slot's tile, the ellipse cull, the sentinels
  + sort                 the one sort of (tile << 32) | rank
  FULL bin_instances     the function itself (ranges, cap, padding)

profile_binning.py timed bin_instances whole in its sorted and its aligned
layout; the sorted one is FULL here, the aligned one has no counterpart:
the port bins in the sorted layout only. `+ sort` must equal
bin_instances' sorted keys bit for bit (tests/test_torch_stage_tools.py
holds it), so the mirror cannot drift from the code unseen.

Each row: ms by CUDA events, device busy ms and kernels per call
(`timing.profile_cuts`). Run on the card (--cpu is refused):

    python -m gslivm_tpu_torch.tools.profile_binning [--reps 20]
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import torch

from ..ops.binning import bin_instances
from ..ops.rasterize_reference import TILE, TILE_CULL_EPS, preprocess, tile_grid, tile_min_power
from ..utils.device import device_name
from .exp_block import HEIGHT, N, WIDTH, bench_scene
from .timing import cuda_device, profile_cuts

MAXI = 6700 * 128
BLOCK = (2, 2)
MAXCH = 16
SLACK = 0.2


class Geometry(NamedTuple):
    width: int
    height: int
    max_instances: int
    block_x: int
    block_y: int

    @property
    def sgrid(self) -> tuple[int, int]:
        gx, gy = tile_grid(self.width, self.height)
        return -(-gx // self.block_x), -(-gy // self.block_y)

    @property
    def num_tiles(self) -> int:
        sgx, sgy = self.sgrid
        return sgx * sgy


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20, help="calls a cut is timed over")
    ap.add_argument("--cpu", action="store_true")
    return ap


def upto_gtab(pre, geo: Geometry) -> dict:
    depth = pre.depth.detach()
    dorder = torch.argsort(torch.where(pre.valid, depth, torch.full_like(depth, float("inf"))),
                           stable=True)
    rect_min = pre.rect_min[dorder].long()
    rect_max = pre.rect_max[dorder].long()
    return {"dorder": dorder, "rmin_x": rect_min[:, 0], "rmin_y": rect_min[:, 1],
            "rmax_x": rect_max[:, 0], "rmax_y": rect_max[:, 1], "validg": pre.valid[dorder]}


def upto_counts(pre, geo: Geometry) -> dict:
    s = upto_gtab(pre, geo)
    rmin_x, rmin_y, rmax_x, rmax_y = s["rmin_x"], s["rmin_y"], s["rmax_x"], s["rmax_y"]
    if (geo.block_x, geo.block_y) != (1, 1):
        empty = (rmax_x <= rmin_x) | (rmax_y <= rmin_y)
        rmin_x = rmin_x // geo.block_x
        rmin_y = rmin_y // geo.block_y
        rmax_x = torch.where(empty, rmin_x, -((-rmax_x) // geo.block_x))
        rmax_y = torch.where(empty, rmin_y, -((-rmax_y) // geo.block_y))
    counts = torch.where(s["validg"], (rmax_x - rmin_x) * (rmax_y - rmin_y),
                         torch.zeros_like(rmax_x))
    offsets = torch.cumsum(counts, 0) - counts
    return {**s, "rmin_x": rmin_x, "rmin_y": rmin_y, "rmax_x": rmax_x, "rmax_y": rmax_y,
            "counts": counts, "offsets": offsets, "total": counts.sum()}


def upto_gid(pre, geo: Geometry) -> dict:
    s = upto_counts(pre, geo)
    slots = torch.arange(-(-geo.max_instances // 128) * 128, device=s["offsets"].device)
    gid = torch.searchsorted(s["offsets"], slots, right=True) - 1
    return {**s, "slots": slots, "gid": gid,
            "slot_valid": slots < torch.clamp(s["total"], max=geo.max_instances)}


def upto_meta(pre, geo: Geometry) -> dict:
    s = upto_gid(pre, geo)
    gid = s["gid"]
    op = torch.where(pre.valid, pre.opacity.detach(), torch.zeros_like(pre.depth))
    ca, cb, cc = (pre.conic[:, i].detach() for i in range(3))
    lq = torch.where(op > 0.0, torch.log(torch.clamp(op, min=1e-30) / TILE_CULL_EPS) + 1e-6,
                     torch.full_like(op, -float("inf")))
    g = s["dorder"][gid]
    mean2d = pre.mean2d.detach()
    return {**s, "rect_w": torch.clamp(s["rmax_x"] - s["rmin_x"], min=1)[gid],
            "off_slot": s["offsets"][gid], "rx": s["rmin_x"][gid], "ry": s["rmin_y"][gid],
            "feat": (mean2d[g, 0], mean2d[g, 1], ca[g], cb[g], cc[g]),
            "rb": ((-cb / torch.clamp(ca, min=1e-12))[g], (-cb / torch.clamp(cc, min=1e-12))[g]),
            "lq": lq[g]}


def upto_tileid(pre, geo: Geometry) -> dict:
    s = upto_meta(pre, geo)
    k = s["slots"] - s["off_slot"]
    q = k // s["rect_w"]
    tx = s["rx"] + (k - q * s["rect_w"])
    ty = s["ry"] + q
    tile_id = ty * geo.sgrid[0] + tx
    sentinel = torch.full_like(tile_id, geo.num_tiles)
    qmin = tile_min_power(*s["feat"], tx, ty, pw=TILE * geo.block_x, ph=TILE * geo.block_y,
                          rb_a=s["rb"][0], rb_c=s["rb"][1])
    tile_id = torch.where(qmin <= s["lq"], tile_id, sentinel)
    return {**s, "tile_id": torch.where(s["slot_valid"], tile_id, sentinel)}


def upto_sort(pre, geo: Geometry) -> dict:
    s = upto_tileid(pre, geo)
    key = (s["tile_id"] << 32) | s["gid"]
    return {**s, "key": key, "key_sorted": torch.sort(key).values[:geo.max_instances]}


MIRRORED_CUTS = (("argsort+gtab permute", upto_gtab), ("+ counts/offsets", upto_counts),
                 ("+ expansion gid", upto_gid), ("+ meta gather", upto_meta),
                 ("+ tileid & cull", upto_tileid), ("+ sort", upto_sort))


def run(args, device="cuda", log=print) -> dict:
    """The mirrored cuts and FULL bin_instances, timed by
    timing.profile_cuts."""
    dev = cuda_device(device)
    params, cam = bench_scene(device=dev)
    with torch.no_grad():
        pre = preprocess(*params, cam)
    geo = Geometry(cam.width, cam.height, MAXI, *BLOCK)

    def full():
        return bin_instances(pre, cam.width, cam.height, MAXI, MAXCH, capacity_slack=SLACK,
                             block_x=BLOCK[0], block_y=BLOCK[1])

    cuts = [(name, lambda f=fn: f(pre, geo), ()) for name, fn in MIRRORED_CUTS]
    cuts.append(("FULL bin_instances", full, ()))
    rows = profile_cuts(cuts, reps=args.reps, device=dev, log=log)
    b = full()
    return {"device": device_name(dev), "scene": [N, WIDTH, HEIGHT],
            "budgets": {"max_instances": MAXI, "max_chunks_per_tile": MAXCH,
                        "capacity_slack": SLACK, "block": list(BLOCK)},
            "expansion": int(b.num_instances), "overflow": int(b.overflow),
            "reps": args.reps, "cuts": rows}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
