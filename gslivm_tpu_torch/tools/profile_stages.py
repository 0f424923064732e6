"""Stage-by-stage profile of the 1080p rasterizer on the bench scene (port
of tools/profile_stages.py).

The bench scene (`exp_block.bench_scene`: 200,000 gaussians from
default_rng(0), one 1920x1080 camera) at the JAX tool's budgets:
max_instances 6700*128, capacity slack 0.2, 16 chunks a tile, supertile
2x2. It prints the instance statistics (expansion, kept, overflow, padded
capacity, chunks), then times cumulative prefixes of the pipeline; a
stage's cost is the difference between consecutive rows.

Forward cuts (the default mode), each a function of the five parameters:

  preprocess                  ops/rasterize_reference.preprocess
  + binning                   ops/binning.bin_instances
  + feature pack              bin_tiles (bin_instances, then the rank
                              table) and the column gather
                              table.t()[gid_sorted]
  + fwd kernel                composite_tiles: K1
  full fwd (loss)             rasterize_tiles, sum((C - 0)^2) + 0.1 sum(A)
  fwd+bwd kernel-only grads   the five gradients of the sum of squares of
                              the tiles' first five rows (K1, K2)
  FULL fwd+bwd                the five gradients of the full loss

Backward cuts (`bwd`), on a forward state built once (ones as the tile
cotangent):

  fwd kernel (ckpt) only      K1 with its chunk checkpoints
  bwd kernel only             K2: the rank table's gradient
  + backward to the preprocessed fields
                              K2, then autograd through the rank table's
                              permutation to preprocess' outputs (mean2d,
                              conic, opacity, color, depth)
  + backward to the five parameters
                              K2, then autograd through the permutation
                              and preprocess

The JAX tool's `+ zero never-written` and `+ grad scatter-add` cuts have
no counterpart: K2 sums each instance's gradient into its gaussian's
column itself, so there is no padded per-instance layout to clear and no
scatter-add after it. The cut at the preprocessed fields is the port's
own: it splits the backward outside K2 into the permutation's part and
preprocess' part. The JAX tool ran its two full cuts at
rasterize_pallas' default chunks and slack (to share bench.py's compiled
executable); here every cut runs at the tool's budgets, so a difference
between two rows is a stage, never a change of budget.

Each cut reports its ms by CUDA events, its device busy ms and kernels per
call (torch.profiler), the busy ms of K1, K2 and K3 in it and of the other
kernels, and its difference from the previous cut (`timing.profile_cuts`).
The budgets must not overflow: if they do, the tool prints the statistics
and stops. Run on the card (--cpu is refused):

    python -m gslivm_tpu_torch.tools.profile_stages [bwd] [--reps 20]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.binning import _padded_capacity, bin_instances
from ..ops.rasterize_reference import preprocess
from ..ops.rasterize_tiles import bin_tiles, composite_tiles, composite_tiles_bwd, render_from_table
from ..utils.device import device_name
from .exp_block import HEIGHT, N, WIDTH, bench_scene, loss_grad, sweep_loss
from .timing import cuda_device, profile_cuts

MAXI = 6700 * 128
BLOCK = (2, 2)
SLACK = 0.2
MAXCH = 16
# the tool's budgets as bin_tiles / rasterize_tiles keywords
BUDGETS = {"max_instances": MAXI, "max_chunks_per_tile": MAXCH, "capacity_slack": SLACK,
           "block_x": BLOCK[0], "block_y": BLOCK[1]}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="fwd", choices=("fwd", "bwd"))
    ap.add_argument("--reps", type=int, default=20, help="calls a cut is timed over")
    ap.add_argument("--cpu", action="store_true")
    return ap


def bin_pre(pre, cam, kw=BUDGETS):
    """bin_instances of a preprocessed set at the budgets `kw`."""
    return bin_instances(pre, cam.width, cam.height, kw["max_instances"],
                         kw["max_chunks_per_tile"], capacity_slack=kw["capacity_slack"],
                         block_x=kw["block_x"], block_y=kw["block_y"])


def pack_pre(pre, cam, kw=BUDGETS):
    """(inst [max_instances, FEAT], binned, cfg, table): the rank table of a
    preprocessed set and its columns gathered into sorted-slot order."""
    table, binned, cfg = bin_tiles(pre, cam.width, cam.height, **kw)
    return table.t()[binned.gid_sorted.long()].contiguous(), binned, cfg, table


@torch.no_grad()
def instance_stats(args, cam, kw=BUDGETS) -> dict:
    """The JAX tool's statistics of the scene binned at `kw`."""
    b = bin_pre(preprocess(*args, cam), cam, kw)
    num_tiles = b.tile_nchunks.shape[0]
    nch = b.tile_nchunks.double()
    return {"expansion": int(b.num_instances), "kept": int(b.cnt_allowed.sum()),
            "overflow": int(b.overflow),
            "padded_capacity": _padded_capacity(kw["max_instances"], num_tiles,
                                                kw["capacity_slack"]),
            "chunks_total": int(nch.sum()), "chunks_max": int(nch.max()),
            "chunks_mean": float(nch.mean())}


# ---- forward cuts: functions of the five parameters ------------------------

def s_pre(args, cam, kw=BUDGETS):
    return preprocess(*args, cam)


def s_bin(args, cam, kw=BUDGETS):
    return bin_pre(preprocess(*args, cam), cam, kw)


def s_pack(args, cam, kw=BUDGETS):
    return pack_pre(preprocess(*args, cam), cam, kw)[0]


def s_fwd(args, cam, kw=BUDGETS):
    inst, b, cfg, _ = pack_pre(preprocess(*args, cam), cam, kw)
    return composite_tiles(inst, b.sorted_start, b.tile_nchunks, b.cnt_allowed, cfg)


def full_loss(args, cam, kw=BUDGETS):
    return sweep_loss(args, cam, **kw)


def _leaves(args):
    return [a.detach().requires_grad_(True) for a in args]


def kernel_grads(args, cam, kw=BUDGETS):
    """The five gradients of the sum of squares of the tiles' first five
    rows (C, D, A): K1 with checkpoints forward, K2 backward."""
    leaves = _leaves(args)
    table, binned, cfg = bin_tiles(preprocess(*leaves, cam), cam.width, cam.height, **kw)
    tiles = render_from_table(table, binned, cfg)
    return torch.autograd.grad((tiles[:, :5] ** 2).sum(), leaves)


def full_grads(args, cam, kw=BUDGETS):
    return loss_grad(cam, **kw)(*args)


FWD_CUTS = (("preprocess", s_pre), ("+ binning", s_bin), ("+ feature pack", s_pack),
            ("+ fwd kernel", s_fwd), ("full fwd (loss)", full_loss),
            ("fwd+bwd kernel-only grads", kernel_grads), ("FULL fwd+bwd", full_grads))


# ---- backward cuts: on one fixed forward state -----------------------------

def bwd_state(args, cam, kw=BUDGETS, cotangent=torch.ones_like) -> dict:
    """The forward state the backward cuts start from: preprocess' outputs
    that enter the rank table (`fields`, with their autograd graph back to
    the five parameters), the rank table built from detached copies of
    them (`cut`, so its graph ends there: a total derivative at depth would
    also run through mean2d), the gathered instances, K1's tiles and
    checkpoints, and the tile cotangent cotangent(tiles)."""
    leaves = _leaves(args)
    pre = preprocess(*leaves, cam)
    fields = [pre.mean2d, pre.conic, pre.opacity, pre.color, pre.depth]
    cut = [f.detach().requires_grad_(True) for f in fields]
    table, binned, cfg = bin_tiles(
        pre._replace(**dict(zip(("mean2d", "conic", "opacity", "color", "depth"), cut))),
        cam.width, cam.height, **kw)
    with torch.no_grad():
        inst = table.t()[binned.gid_sorted.long()].contiguous()
        out, ckpt = composite_tiles(inst, binned.sorted_start, binned.tile_nchunks,
                                    binned.cnt_allowed, cfg, save_ckpt=True)
    return {"leaves": leaves, "fields": fields, "cut": cut, "table": table, "binned": binned,
            "cfg": cfg, "inst": inst, "out": out, "ckpt": ckpt, "g_tiles": cotangent(out)}


def s_fwd_ckpt(st):
    b = st["binned"]
    o, _ = composite_tiles(st["inst"], b.sorted_start, b.tile_nchunks, b.cnt_allowed,
                           st["cfg"], save_ckpt=True)
    return o[:, :5].sum() + st["g_tiles"][0, 0, 0]


def s_bwd_kernel(st):
    b = st["binned"]
    return composite_tiles_bwd(st["inst"], b.sorted_start, b.cnt_allowed, st["g_tiles"],
                               st["out"], st["ckpt"], st["cfg"], st["table"].shape[1])


def s_bwd_fields(st):
    return torch.autograd.grad(st["table"], st["cut"], s_bwd_kernel(st),
                               retain_graph=True)


def s_bwd_params(st):
    return torch.autograd.grad(st["fields"], st["leaves"], s_bwd_fields(st),
                               retain_graph=True)


BWD_CUTS = (("fwd kernel (ckpt) only", s_fwd_ckpt), ("bwd kernel only", s_bwd_kernel),
            ("+ backward to the preprocessed fields", s_bwd_fields),
            ("+ backward to the five parameters", s_bwd_params))


def run(args, device="cuda", log=print) -> dict:
    """The statistics, then the cuts of args.mode timed by
    timing.profile_cuts. Raises on a non-CUDA device, and stops (raises)
    if the budgets overflow."""
    dev = cuda_device(device)
    params, cam = bench_scene(device=dev)
    stats = instance_stats(params, cam)
    log(f"expansion total (rect area): {stats['expansion']}")
    log(f"kept after cull+cap        : {stats['kept']}")
    log(f"overflow                   : {stats['overflow']}")
    log(f"padded capacity            : {stats['padded_capacity']}")
    log(f"chunks: total {stats['chunks_total']}, max/tile {stats['chunks_max']}, "
        f"mean/tile {stats['chunks_mean']:.2f}")
    if stats["overflow"]:
        raise RuntimeError(f"the budgets {BUDGETS} overflow on the bench scene: {stats}")
    if args.mode == "fwd":
        cuts = [(name, lambda *a, f=fn: f(a, cam), params) for name, fn in FWD_CUTS]
    else:
        st = bwd_state(params, cam)
        cuts = [(name, lambda f=fn: f(st), ()) for name, fn in BWD_CUTS]
    rows = profile_cuts(cuts, reps=args.reps, device=dev, log=log)
    return {"device": device_name(dev), "mode": args.mode, "scene": [N, WIDTH, HEIGHT],
            "budgets": BUDGETS, "reps": args.reps, "stats": stats, "cuts": rows}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    res = run(args, device="cpu" if args.cpu else "cuda")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
