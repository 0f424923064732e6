"""Run one cell of the benchmark of gslivm_tpu_torch once, and print one
JSON line.

    python3 -m benchmark.run --workload botanic.map --seed 7 --seconds 30 --trace 0

from the root of a checkout. Everything is found by name from
BENCHMARK.json: the cell's file `benchmark/cells/<cell>.json` (its
traffic parameters, its driver and its limits), the configuration's file,
the driver `benchmark/drivers/<driver>.py` and, with `--trace 1`, each
per-layer metric's reader `benchmark/metrics/<metric>.py`. A driver
builds the program's state from the seed (set-up), measures for
`--seconds`, then checks what the timed path produced against the plain
reference; the harness turns its record into the result line.

Exit codes: 0 with a result line; 2 without a card (or fewer than the
cell asks for); 3 if JAX or the JAX package is loaded once the window has
closed; 1 on any other failure. Without the program beside it
(`gslivm_tpu_torch`), a run fails.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gslivm_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


def set_environment():
    """Every cache of the run inside the checkout, at fixed paths; few
    host threads; no JAX pulled in by a library."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "4"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell's entries, found by name in BENCHMARK.json."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        self.bench = bench
        work = [w for w in bench["workloads"] if w["name"] == name]
        if not work:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = work[0]
        self.name = name
        self.root = root
        cfg = [c for c in bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(root, cfg["file"])
        self.cell = load_json(root, "benchmark", "cells", name + ".json")
        self.driver_name = self.cell["driver"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class Context:
    """What a driver is handed."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: bool = False, log=None):
        from benchmark.trace import Tracer  # noqa: PLC0415

        self.cell = cell
        self.config = cell.config
        self.traffic = cell.cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.tracer = Tracer(trace)
        self.trace = bool(trace)
        self.device = device
        self.control = control
        self.log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def judge(checks: list[dict]) -> bool:
    """A check holds when its value is finite and at most its limit."""
    return all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks)


def result_line(cell: Cell, ctx: Context, rec: dict, device: dict) -> dict:
    """The last line: correct, attempted, failed, metrics, device, with
    --trace 1 the breakdown, and the checks last."""
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer():
            reader = load_file(os.path.join(cell.root, "benchmark", "metrics", m["name"] + ".py"),
                               "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            if m["name"] not in rec["metrics"]:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(rec["metrics"][m["name"]]), "unit": m["unit"]}
    checks = rec["checks"]
    line = {"correct": judge(checks) and not rec.get("fault"),
            "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
            "metrics": metrics, "device": device}
    if ctx.trace and rec.get("breakdown"):
        line["breakdown"] = rec["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return line


def run(cell: Cell, ctx: Context) -> dict:
    """Set-up, window and check through the cell's driver: its record."""
    driver = importlib.import_module("benchmark.drivers." + cell.driver_name)
    return driver.run(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    chips = int(cell.workload["chips"])

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    rec = run(cell, ctx)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if ctx.trace:
        w = ctx.tracer.result
        device["busy_s"], device["window_s"] = w.busy_s, w.window_s
    device["power_limit"] = power_limit()
    line = result_line(cell, ctx, rec, device)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
