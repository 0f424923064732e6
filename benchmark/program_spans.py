"""The program's own spans in a cell of the benchmark: a `--trace 1` run of
the cell's driver, unchanged, with the spans of gslivm_tpu_torch
(`utils/timer.py`) on from the window's first frame to the end of the
profiled frame, and the per-layer numbers they give.

    python3 -m benchmark.program_spans --workload botanic.map --seeds 11,12 \
        --seconds 51 [--spans 1,0]

For each seed, one run a value of `--spans` (1: spans on; 0: off, the
same run as `benchmark.run --trace 1`), in turn, in one process; one JSON
line a run on standard output, the idle gaps by program range on standard
error. A run's record is the driver's, with two more entries: the window's
span aggregates and the mapper's counters over the window
(`program_spans`), and the profiled frame's device records attributed to
the program range that launched them (`program_trace`). The metric
functions below read a record and return None where it lacks the data.

Attribution: a device record (kernel, copy, set) carries the correlation
id of its launch, the host runtime event of the same id (`cudaLaunchKernel`
and its kin); its range is the innermost `gslivm.*` range, on any thread,
whose host time encloses the launch (K2 is launched on autograd's device
thread, inside `step.backward`'s time on the calling thread). Records
launched outside every range, the benchmark's own copies of the map among
them, are left unattributed.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time

import torch

from benchmark import run as R
from benchmark import trace
from benchmark.drivers import common

PREFIX = "gslivm."
KERNELS = ("K1", "K2", "K3")
# host ms of a span a window iteration: metric -> span
HOST = {"sample_ms.map": "train.sample", "feedback_ms.map": "train.feedback",
        "render_host_ms.map": "step.render", "loss_host_ms.map": "step.loss",
        "backward_host_ms.map": "step.backward", "adam_host_ms.map": "step.adam"}
# device ms launched under a span a traced iteration, less its kernels:
# metric -> (span, kernels left out)
BUSY = {"render_busy_ms.map": ("step.render", ("K1",)),
        "loss_busy_ms.map": ("step.loss", ("K3",)),
        "backward_busy_ms.map": ("step.backward", ("K2", "K3")),
        "adam_busy_ms.map": ("step.adam", ())}


# ---------------------------------------------------------------- metrics

def host_ms(rec: dict, span: str):
    """Host ms of `span` a train_iteration over the window."""
    w = rec.get("program_spans")
    if not w or not w["window"].get("train", {}).get("count"):
        return None
    return w["window"].get(span, {}).get("total_ns", 0) / 1e6 / w["window"]["train"]["count"]


def _whole_trace(rec: dict):
    t, p = rec.get("trace"), rec.get("program_trace")
    if not t or not p or not t["records_whole"] or not t.get("iterations"):
        return None
    return t, p


def busy_ms(rec: dict, span: str, leave_out=()):
    """Device ms launched under `span` a traced iteration, less the
    hand-written kernels in `leave_out`."""
    tp = _whole_trace(rec)
    if tp is None:
        return None
    t, p = tp
    under = p["under"].get(span)
    if under is None:
        return None
    secs = sum(under["seconds"].values()) - sum(under["seconds"].get(k, 0.0) for k in leave_out)
    return 1e3 * secs / t["iterations"]


def launches_per_iter(rec: dict):
    """Device records (kernels, copies, sets) launched under `train` a
    traced iteration."""
    tp = _whole_trace(rec)
    if tp is None or "train" not in tp[1]["under"]:
        return None
    return tp[1]["under"]["train"]["records"] / tp[0]["iterations"]


def truncated_share(rec: dict):
    """100 x the window's feedback rows that overflowed over those read."""
    w = rec.get("program_spans")
    if not w or w.get("feedback_steps") is None or not w["feedback_steps"]:
        return None
    return 100.0 * w["truncated_steps"] / w["feedback_steps"]


def metrics(rec: dict) -> dict:
    """The twelve per-layer numbers of a record, None where it lacks them."""
    out = {m: host_ms(rec, s) for m, s in HOST.items()}
    out.update({m: busy_ms(rec, s, k) for m, (s, k) in BUSY.items()})
    out["launches_per_iter.map"] = launches_per_iter(rec)
    out["truncated_steps.map"] = truncated_share(rec)
    return out


# ------------------------------------------------------------ attribution

class Ranges:
    """The program's host ranges [(name, start_us, end_us)], any thread."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.starts = [r[1] for r in self.ranges]

    def at(self, t: float) -> list[str]:
        """Names of the ranges whose time holds `t`, outermost first."""
        hit = [r for r in self.ranges[:bisect.bisect_right(self.starts, t)] if t <= r[2]]
        return [r[0] for r in sorted(hit, key=lambda r: r[1] - r[2])]


def attribute(ranges, records) -> dict:
    """Device seconds and record counts under each range name (a record
    counts under every range that encloses its launch) and by innermost
    range. ranges: [(name, start_us, end_us)]; records: [(kernel key,
    seconds, launch_us or None)]."""
    ranges = Ranges(ranges)
    under, innermost = {}, {}
    lone_s, lone_n, unmatched = 0.0, 0, 0
    for key, secs, t in records:
        unmatched += t is None
        names = [] if t is None else ranges.at(t)
        if not names:
            lone_s += secs
            lone_n += 1
            continue
        for n in set(names):
            u = under.setdefault(n, {"seconds": {}, "records": 0})
            u["seconds"][key] = u["seconds"].get(key, 0.0) + secs
            u["records"] += 1
        innermost[names[-1]] = innermost.get(names[-1], 0.0) + secs
    return {"under": under, "innermost": innermost, "unattributed_s": lone_s,
            "unattributed_records": lone_n, "unmatched_records": unmatched}


def idle_by_span(ranges, device) -> dict:
    """Idle seconds between device records (Intervals), by the innermost
    range at each gap's middle."""
    ranges = Ranges(ranges)
    out, end = {}, None
    for d in sorted(device, key=lambda d: d.start_us):
        if end is not None and d.start_us > end:
            names = ranges.at((end + d.start_us) / 2)
            name = names[-1] if names else "outside program spans"
            out[name] = out.get(name, 0.0) + (d.start_us - end) / 1e6
        end = d.end_us if end is None else max(end, d.end_us)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def kernel_key(name: str) -> str:
    return next((k for k, n in trace.KERNEL_NAMES.items() if n in name), "other")


def profile_records(events):
    """(ranges, records) of a profiler's events: the `gslivm.*` host
    ranges, and each device record with its kernel key, seconds and the
    start of the runtime call that launched it: the host event named
    `cu...` (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...) that
    carries the record's correlation id (a host op may carry the same
    number as its own id), None if none does."""
    ranges, device, runtime = [], [], {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(e)
        elif e.name.startswith(PREFIX):
            ranges.append((e.name[len(PREFIX):], e.time_range.start, e.time_range.end))
        elif e.name.startswith("cu"):
            runtime[e.id] = e.time_range.start
    records = [(kernel_key(d.name), (d.time_range.end - d.time_range.start) / 1e6,
                runtime.get(d.id)) for d in device]
    return ranges, records


# ------------------------------------------------------------------ a run

class SpanTracer(trace.Tracer):
    """The benchmark's tracer, which also turns the program's spans on (or,
    with spans=False, only resets them) at the window's first span, reads
    their aggregates and the mapper's counters when the profiled frames
    begin, and attributes the profiled frames' device records."""

    def __init__(self, spans: bool):
        super().__init__(True)
        self.spans = spans
        self.mapper = None
        self.started = False
        self.program_spans = None
        self.program_trace = None

    def _counters(self):
        return (getattr(self.mapper, "truncated_steps", None),
                getattr(self.mapper, "feedback_steps", None))

    def span(self, name: str):
        if not self.started:
            from gslivm_tpu_torch.utils import timer  # noqa: PLC0415

            self.started = True
            timer.reset()
            timer.tracing(self.spans)
            self._base = self._counters()
        return super().span(name)

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        from gslivm_tpu_torch.utils import timer  # noqa: PLC0415

        now = self._counters()
        self.program_spans = {
            "window": timer.read(),
            "truncated_steps": None if now[0] is None else now[0] - self._base[0],
            "feedback_steps": None if now[1] is None else now[1] - self._base[1]}
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                yield
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            timer.tracing(False)
        self.result = trace.read(prof, wall)
        ranges, records = profile_records(prof.events())
        self.program_trace = attribute(ranges, records)
        self.program_trace["idle_by_span"] = idle_by_span(ranges, self.result.device)


@contextlib.contextmanager
def caught_mapper(tracer: SpanTracer):
    """While entered, the drivers' mapper is handed to the tracer."""
    make = common.mapper

    def caught(*a, **kw):
        tracer.mapper = make(*a, **kw)
        return tracer.mapper

    common.mapper = caught
    try:
        yield
    finally:
        common.mapper = make


def summary(rec: dict, line: dict) -> dict:
    """The numbers a run reports: the driver's per-layer metrics, the
    twelve, and how far the spans cover the iteration and the trace."""
    out = {"correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "program": metrics(rec)}
    w = rec.get("program_spans")
    if w and w["window"].get("train"):
        win = w["window"]
        n = win["train"]["count"]
        out["host_ms"] = {k: v["total_ns"] / 1e6 / n for k, v in win.items()}
        out["self_ms"] = {k: v["self_ns"] / 1e6 / n for k, v in win.items()}
        out["counts_per_iter"] = {k: v["count"] / n for k, v in win.items()}
        out["train_self_share"] = win["train"]["self_ns"] / win["train"]["total_ns"]
        iter_ms = statistics.fmean(rec["spans"]["train"]) * 1e3
        out["host_six_share_of_train_iter"] = sum(
            out["program"][m] or 0.0 for m in HOST) / iter_ms
    tp = _whole_trace(rec)
    if tp is not None:
        t, p = tp
        it = t["iterations"]
        under = p["under"].get("train", {"seconds": {}})
        total = sum(under["seconds"].values())
        named = sum(out["program"][m] or 0.0 for m in BUSY) / 1e3 * it + sum(
            under["seconds"].get(k, 0.0) for k in KERNELS)
        out["trace"] = {
            "train_device_ms": 1e3 * total / it,
            "kernels_ms": {k: 1e3 * under["seconds"].get(k, 0.0) / it for k in KERNELS},
            "covered_share": named / total if total else None,
            "innermost_ms": {k: 1e3 * v / it for k, v in sorted(
                p["innermost"].items(), key=lambda kv: -kv[1])},
            "launches_per_iter": {k: v["records"] / it for k, v in p["under"].items()},
            "unattributed_ms": 1e3 * p["unattributed_s"],
            "unattributed_records": p["unattributed_records"],
            "unmatched_records": p["unmatched_records"]}
    return out


def run_one(cell, seed: int, seconds: float, spans: bool, device: str = "cuda") -> dict:
    tracer = SpanTracer(spans)
    ctx = R.Context(cell, seed, seconds, True, device=device)
    ctx.tracer = tracer
    with caught_mapper(tracer):
        rec = R.run(cell, ctx)
    rec["program_spans"], rec["program_trace"] = tracer.program_spans, tracer.program_trace
    line = R.result_line(cell, ctx, rec, {})
    return rec, summary(rec, line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", default="1", help="comma-separated 0/1, in turn a seed")
    args = ap.parse_args(argv)
    R.set_environment()
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = R.Cell(R.load_json(R.ROOT, "BENCHMARK.json"), args.workload)
    card = {"kind": torch.cuda.get_device_name(0), "power_limit": R.power_limit()}
    for seed in (int(s) for s in args.seeds.split(",")):
        for spans in (bool(int(s)) for s in args.spans.split(",")):
            rec, out = run_one(cell, seed, args.seconds, spans)
            if rec.get("program_trace"):
                print(f"idle by program range (seed {seed}, spans {int(spans)}):",
                      json.dumps(rec["program_trace"]["idle_by_span"]), file=sys.stderr)
            print(json.dumps({"workload": args.workload, "seed": seed, "spans": int(spans),
                              "device": card, **out}), flush=True)
            del rec
            common.release("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
