"""Scaling of the sharded train step over mesh sizes (port of
tools/scaling_bench.py onto torch.distributed).

Times `parallel.sharding.sharded_train_step` at growing meshes and reports
rays/s, the efficiency against the first size and, with --phases for the
primitive renderer, its split into preprocess + exchange, band render,
merge + gather and the rest of the step (backward, whose reverse
collectives are the gradient reduction, the losses and Adam), with the
collective share derived. Every rank of the world runs the same command; a
mesh of N ranks is the first N ranks of the world (the others wait), with
2 gauss rows when N is even and >= 4. Rank 0 prints one JSON line per size:

  {"devices": N, "processes": world, "mesh": {...}, "renderer": ...,
   "ms_per_step": ..., "rays_per_s": ..., "efficiency_vs_1": ...,
   "overflow": ..., "device": ..., "phases_ms": {...}, "comm_fraction": ...}

Ranks and rendezvous (the JAX tool's jax.distributed.initialize):
  torchrun --nproc-per-node N -m gslivm_tpu_torch.tools.scaling_bench
      NCCL, one card a rank (LOCAL_RANK), env:// rendezvous;
  --coordinator HOST:PORT --num-processes N --process-id R, on every host
      the same command, a tcp:// rendezvous at process 0;
  python -m gslivm_tpu_torch.tools.scaling_bench --cpu --devices 1 2 4
      spawns max(--devices) gloo ranks on the CPU (multihost_demo's
      spawner): correctness-shaped timings of the same code path;
  with no launcher on a card, one NCCL rank: N = 1 only. One card cannot
      hold a larger N (NCCL runs one rank per card); a larger --devices
      prints a row saying so and is not run.

The renderer "pallas" is the JAX name of the port's "tiles". Timings are
the host clock over --iters steps between barriers, the card synchronised.
The JAX tool's --dump-hlo (the compiled HLO schedule's overlap of async
collectives with compute) has no counterpart: eager torch collectives are
not scheduled by a compiler, and nothing here reports their overlap yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

RENDERERS = {"primitive": "primitive", "pallas": "tiles", "tiles": "tiles",
             "oracle": "oracle"}
SIZES = (1, 2, 4, 8, 16, 32)
MODULE = "gslivm_tpu_torch.tools.scaling_bench"


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="mesh sizes to test (default: 1,2,4,.. up to the world)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--gauss", type=int, default=20000)
    ap.add_argument("--renderer", default="primitive", choices=sorted(RENDERERS))
    ap.add_argument("--max-instances", type=int, default=1 << 17)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--phases", action="store_true",
                    help="per-phase breakdown (primitive renderer): "
                         "preprocess+exchange / +render / +merge+gather / "
                         "full step; comm_fraction derived")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (enables multi-host)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def _timed(fn, iters: int, device, group) -> float:
    """ms per call of fn over `iters` calls after one warm-up call, from a
    barrier to a barrier of `group`, the mesh's ranks (the card
    synchronised)."""
    import torch.distributed as dist  # noqa: PLC0415

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier(group=group)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e3


def _phase_breakdown(mesh, shard, cam, args, full_ms: float, device, group):
    """Cumulative-prefix timings of the primitive pipeline, forward only:
    preprocess + exchange (the depth keys' all_gather and the all_to_all of
    the screen rows), + the band render of the slab, + the merge over
    "gauss" and the band all_gather over "pixel". The full step adds the
    backward (the reverse collectives: the gradient reduction), the losses
    and Adam. comm_fraction counts exchange + merge twice (their backward
    twins at the same cost) over the full step."""
    from ..parallel import collectives as C  # noqa: PLC0415
    from ..parallel import primitive, sharding  # noqa: PLC0415

    gauss, pixel = sharding.mesh_axis(mesh, "gauss"), sharding.mesh_axis(mesh, "pixel")
    block = (1, 1)
    band_rows = sharding.band_rows_for(cam, pixel.size, block)

    def exchange():
        pre = sharding._preprocess(shard, cam)
        budget = primitive.default_budget(pre.depth.shape[0], gauss.size)
        return primitive.exchange_by_depth_slab(pre, gauss.group, budget)

    def render():
        slab, _ = exchange()
        partial, _ = primitive.render_slab_band(
            slab, cam.width, cam.height, band_rows, pixel.index * band_rows,
            max_instances=args.max_instances, block=block)
        return partial

    def s_exchange():
        slab, ovf = exchange()
        return slab.mean2d.sum() + ovf

    def s_merge():
        merged = primitive.merge_partials(render(), gauss.group)
        return C.all_gather(merged, pixel.group, dim=1).sum()

    with torch.no_grad():
        ms_ex = _timed(s_exchange, args.iters, device, group)
        ms_re = _timed(lambda: render().sum(), args.iters, device, group)
        ms_me = _timed(s_merge, args.iters, device, group)
    phases = {"preprocess_exchange": ms_ex, "render_band": ms_re - ms_ex,
              "merge_gather": ms_me - ms_re, "bwd_losses_adam": full_ms - ms_me,
              "full_step": full_ms}
    # at toy sizes a cheap stage's cumulative difference can fall below 0
    comm = max(0.0, ms_ex) + max(0.0, ms_me - ms_re)
    return phases, min(1.0, max(0.0, 2.0 * comm / full_ms))


def run_rank(args, rank: int, world: int, init_method: str, log=print) -> list[dict]:
    """This rank's part of the sweep; rank 0 logs and returns the rows."""
    import torch.distributed as dist  # noqa: PLC0415

    from ..config import GsOptimParams  # noqa: PLC0415
    from ..models import training  # noqa: PLC0415
    from ..parallel import sharding  # noqa: PLC0415
    from ..utils.device import device_name  # noqa: PLC0415
    from .multihost_demo import demo_scene  # noqa: PLC0415

    if args.cpu:
        device = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
    else:
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local)
    sharding.init_process_group(device, rank, world, init_method)
    rows = []
    try:
        params, (cam,), gt, simi = demo_scene(
            args.gauss, args.width, args.height, device,
            capacity=1 << int(np.ceil(np.log2(max(args.gauss, 2)))))
        renderer = RENDERERS[args.renderer]
        op = GsOptimParams()
        rays = args.width * args.height
        name = device_name(device)
        sizes = args.devices or [d for d in SIZES if d <= world]
        base_ms = None
        for n_dev in sizes:
            if n_dev > world:
                row = {"devices": n_dev, "processes": world, "skipped":
                       f"{n_dev} ranks needed, the world has {world}"
                       + (" (one card: NCCL runs one rank a card)" if world == 1
                          and device.type == "cuda" else "")}
                if rank == 0:
                    log(json.dumps(row))
                    rows.append(row)
                continue
            gauss_axis = 2 if (n_dev % 2 == 0 and n_dev >= 4) else 1
            # every rank of the world takes part in making the mesh's groups
            mesh = sharding.make_mesh(n_dev, gauss_axis)
            members = dist.new_group(list(range(n_dev)))
            row = None
            if rank < n_dev:
                shard = sharding.shard_params(params, mesh)
                opt = training.make_optimizer(shard, op)
                metrics = []

                def step():
                    metrics.append(sharding.sharded_train_step(
                        mesh, shard, opt, [cam], gt, simi, opt_params=op,
                        renderer=renderer, max_instances=args.max_instances))

                ms = _timed(step, args.iters, device, members)
                base_ms = ms if base_ms is None else base_ms
                row = {"devices": n_dev, "processes": world,
                       "mesh": {"gauss": gauss_axis, "pixel": n_dev // gauss_axis},
                       "renderer": renderer, "ms_per_step": ms, "rays_per_s": rays / ms * 1e3,
                       "efficiency_vs_1": base_ms / ms / n_dev * sizes[0],
                       "overflow": int(metrics[-1].overflow), "device": name}
                if args.phases and renderer == "primitive":
                    row["phases_ms"], row["comm_fraction"] = _phase_breakdown(
                        mesh, shard, cam, args, ms, device, members)
            dist.barrier()
            if rank == 0:
                log(json.dumps(row))
                rows.append(row)
    finally:
        dist.destroy_process_group()
    return rows


def _rendezvous(args) -> tuple[int, int, str] | None:
    """(rank, world, init method) from --coordinator/--num-processes/
    --process-id or torchrun's environment; None for a lone process."""
    if args.coordinator:
        return args.process_id, args.num_processes, f"tcp://{args.coordinator}"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    return None


def main(argv=None, log=print) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_argparser().parse_args(argv)
    if not args.cpu:
        from ..utils.device import resolve_device  # noqa: PLC0415

        resolve_device("cuda")  # no card: raise here, not in every rank
    rdv = _rendezvous(args)
    if rdv is not None:
        rank, world, init = rdv
        if args.coordinator and (rank is None or world is None):
            raise ValueError("--coordinator needs --num-processes and --process-id")
        run_rank(args, rank, world, init, log)
        return 0
    world = max(args.devices or [1]) if args.cpu else 1
    if world == 1:
        from .multihost_demo import _free_port  # noqa: PLC0415

        run_rank(args, 0, 1, f"tcp://127.0.0.1:{_free_port()}", log)
        return 0
    from .multihost_demo import spawn_ranks  # noqa: PLC0415

    return spawn_ranks(MODULE, argv, world, 300.0, lambda r, init: [
        "--coordinator", init[len("tcp://"):], "--num-processes", str(world),
        "--process-id", str(r)])


if __name__ == "__main__":
    sys.exit(main())
