"""Run the sharded train step across processes (port of
tools/multihost_demo.py onto torch.distributed).

Every rank joins one process group (gloo for --device cpu, NCCL for the
card), builds the same ("gauss", "pixel") mesh and takes one
`sharding.sharded_train_step` per renderer from the same initial map, so
the collectives cross process boundaries as they would across hosts.

    torchrun --nproc-per-node N -m gslivm_tpu_torch.tools.multihost_demo \
        [--gauss-axis G] [--renderer primitive]
    python -m gslivm_tpu_torch.tools.multihost_demo --nproc N --device cpu

With --nproc the script spawns the N ranks itself (a rendezvous on a free
localhost port, each rank with its own timeout, all killed if one fails or
the join times out). Under torchrun each rank takes card LOCAL_RANK.

The map comes from --state (a file written by `save_state`: parameters,
cameras, ground truth, simi inputs), or is the JAX demo's random scene of
--gauss gaussians seen by one --width x --height camera. --renderer takes a
comma list of renderers, each optionally with its exchange slack
("primitive:0.0625"). Rank 0 prints ONE JSON line per renderer: world,
mesh, renderer, loss, overflow, the step's host seconds and rank 0's
K1/K2/K3 launches in the step (counters set to 0 just before it); with
--out it also writes (torch.save) each renderer's metrics, the whole map's gradient
and updated parameters, and every rank's parameter and Adam-moment bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: this process is a rank)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--gauss-axis", default=None,
                    help="gauss rows of the mesh, or a comma list of meshes to run in turn")
    ap.add_argument("--renderer", default="primitive",
                    help="comma list of oracle|tiles|primitive[:exchange_slack]; the "
                         "slack defaults to sharded_train_step's")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--state", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--gauss", type=int, default=2048)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--max-instances", type=int, default=1 << 14)
    ap.add_argument("--block", default="1,1")
    ap.add_argument("--history-pairs", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the rendezvous and each collective")
    return ap.parse_args(argv)


def save_state(path, params, cameras, gt_images, simi, **extra):
    """Write a map and its training inputs for --state: the parameters, the
    cameras' tensors and sizes, gt_images [n, 3, H, W] and the SimiInputs,
    all as CPU tensors."""
    from gslivm_tpu_torch.convert import CAMERA_TENSOR_FIELDS, PARAM_FIELDS  # noqa: PLC0415

    def cpu(x):
        return torch.as_tensor(x).detach().cpu().clone()

    torch.save({
        "params": {f: cpu(getattr(params, f)) for f in PARAM_FIELDS},
        "cameras": [{**{f: cpu(getattr(c, f)) for f in CAMERA_TENSOR_FIELDS},
                     "width": c.width, "height": c.height} for c in cameras],
        "gt": cpu(gt_images),
        "simi": {k: cpu(v) for k, v in simi._asdict().items()},
        **extra,
    }, path)


def load_state(path, device):
    """The (params, cameras, gt_images, simi) of a `save_state` file on device."""
    from gslivm_tpu_torch.models.cameras import Camera  # noqa: PLC0415
    from gslivm_tpu_torch.models.gaussian_model import GaussianParams  # noqa: PLC0415
    from gslivm_tpu_torch.models.training import SimiInputs  # noqa: PLC0415

    st = torch.load(path, map_location="cpu", weights_only=True)
    p = st["params"]
    params = GaussianParams(**{f: v.to(device) for f, v in p.items() if f != "n_active"},
                            n_active=int(p["n_active"]))
    cams = [Camera(**{f: v.to(device) for f, v in c.items() if f not in ("width", "height")},
                   width=int(c["width"]), height=int(c["height"])) for c in st["cameras"]]
    simi = SimiInputs(**{k: v.to(device) for k, v in st["simi"].items()})
    return params, cams, st["gt"].to(device), simi


def demo_scene(n: int, width: int, height: int, device, seed: int = 0):
    """The JAX demo's scene: n gaussians around (0, 0, 5) in front of one
    camera at the origin, random ground truth, no simi anchors."""
    from gslivm_tpu_torch.models import gaussian_model as gm  # noqa: PLC0415
    from gslivm_tpu_torch.models import training  # noqa: PLC0415
    from gslivm_tpu_torch.models.cameras import make_camera  # noqa: PLC0415

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    batch = gm.PointBatch(xyz=t(rng.normal(0, 1.2, (n, 3)) + [0, 0, 5.0]),
                          rgb=t(rng.uniform(0, 255, (n, 3))),
                          cov=t(np.tile(np.eye(3)[None] * 0.002, (n, 1, 1))),
                          mask=torch.ones(n, dtype=torch.bool, device=device))
    params = gm.create_from_points(batch, 3.0, capacity=n)
    cam = make_camera(np.eye(3), np.zeros(3), width, height, fovx=1.0,
                      fovy=1.0 * height / width, device=device)
    gt = t(rng.uniform(size=(1, 3, height, width)))
    return params, [cam], gt, training.empty_simi(max_gauss=n, device=device)


def _rank_device(args, rank: int) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    from gslivm_tpu_torch.utils.device import resolve_device  # noqa: PLC0415

    dev = resolve_device(args.device)
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        dev = torch.device("cuda", local)
    return dev


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_rank(args, rank: int, world: int, init_method: str) -> int:
    """One rank: join the group, build the mesh, one step per renderer."""
    import torch.distributed as dist  # noqa: PLC0415

    from gslivm_tpu_torch.parallel import sharding  # noqa: PLC0415

    dev = _rank_device(args, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    sharding.init_process_group(dev, rank, world, init_method, args.timeout)
    try:
        if args.state:
            params, cams, gt, simi = load_state(args.state, dev)
        else:
            params, cams, gt, simi = demo_scene(args.gauss, args.width, args.height, dev)
        block = tuple(int(v) for v in args.block.split(","))
        axes = [None] if args.gauss_axis is None else [int(g) for g in args.gauss_axis.split(",")]
        results = {}
        for g in axes:
            mesh = sharding.make_mesh(world, g)
            results.update(_steps(args, rank, world, mesh, params, cams, gt, simi, block, dev))
        if rank == 0 and args.out:
            torch.save(results, args.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _steps(args, rank, world, mesh, params, cams, gt, simi, block, dev) -> dict:
    """One sharded step per renderer spec on `mesh`, each from `params`.
    Returns rank 0's results keyed by (gauss rows, spec)."""
    from gslivm_tpu_torch.config import GsOptimParams  # noqa: PLC0415
    from gslivm_tpu_torch.models import training  # noqa: PLC0415
    from gslivm_tpu_torch.parallel import collectives as C  # noqa: PLC0415
    from gslivm_tpu_torch.parallel import sharding  # noqa: PLC0415

    from gslivm_tpu_torch.ops import blur, rasterize_tiles  # noqa: PLC0415

    counters = {"K1": rasterize_tiles.composite_tiles, "K2": rasterize_tiles.composite_tiles_bwd,
                "K3": blur.blur_cuda}
    gauss = sharding.mesh_axis(mesh, "gauss")
    results = {}
    for spec in args.renderer.split(","):
        renderer, _, slack = spec.partition(":")
        shard = sharding.shard_params(params, mesh)
        opt = training.make_optimizer(shard, GsOptimParams())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        m = sharding.sharded_train_step(
            mesh, shard, opt, cams, gt, simi, renderer=renderer,
            max_instances=args.max_instances, block=block,
            n_history_pairs=args.history_pairs,
            **({"exchange_slack": float(slack)} if slack else {}))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        moments = [st[k] for st in opt.state.values() for k in ("exp_avg", "exp_avg_sq")]
        nbytes = C.gather_values(torch.tensor(
            [_nbytes(shard.parameters()), _nbytes(moments)], device=dev), None)
        grads = {f: C.gather_values(getattr(shard, f).grad, gauss.group).cpu()
                 for f in sharding.FIELDS}
        after = {f: C.gather_values(getattr(shard, f).data, gauss.group).cpu()
                 for f in sharding.FIELDS}
        metrics = {k: float(v) for k, v in m._asdict().items()}
        if rank == 0:
            results[(gauss.size, spec)] = {
                "metrics": metrics, "grads": grads, "params": after,
                "bytes": nbytes.reshape(world, 2).cpu(), "seconds": seconds,
                "launches": launches}
            print(json.dumps({
                "world": world, "mesh": {"gauss": gauss.size, "pixel": world // gauss.size},
                "renderer": spec, "loss": metrics["loss"],
                "overflow": int(metrics["overflow"]), "step_s": seconds,
                "launches": launches}), flush=True)
    return results


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args, argv) -> int:
    """Start args.nproc ranks of this script on a localhost rendezvous; join
    them within args.timeout (plus start-up), killing every rank if one
    fails or the time runs out. Returns 0 when every rank exited 0."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    rest, skip = [], False
    for a in argv:  # drop --nproc N
        if skip:
            skip = False
        elif a == "--nproc":
            skip = True
        elif not a.startswith("--nproc="):
            rest.append(a)
    cmd = [sys.executable, "-m", "gslivm_tpu_torch.tools.multihost_demo", *rest,
           "--world", str(args.nproc), "--init-method", init]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    logs = [tempfile.TemporaryFile("w+") for _ in range(args.nproc)]
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], env=env, cwd=os.getcwd(),
                              stderr=log, text=True)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + args.timeout + 60.0
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks did not finish within {args.timeout + 60.0:.0f} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            p.wait()
            log.seek(0)
            if p.returncode:
                rc = rc or p.returncode
                sys.stderr.write(f"rank {r} exited {p.returncode}:\n{log.read()[-4000:]}\n")
            log.close()
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _args(argv)
    if args.device != "cpu":
        from gslivm_tpu_torch.utils.device import resolve_device  # noqa: PLC0415

        resolve_device(args.device)  # no card: raise here, not in every rank
    if args.nproc:
        return spawn(args, argv)
    if args.rank is None:  # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world, init = args.rank, args.world, args.init_method
    return run_rank(args, rank, world, init)


if __name__ == "__main__":
    sys.exit(main())
