"""The benchmark's reading of a device trace: busy time, time by kernel
name, the device operations that took most time and the longest idle
gaps, by what the host was doing.

A frozen copy of the profiler reader of `gslivm_tpu_torch/tools/
timing.py` (`device_busy_ms`: torch.profiler over CPU and CUDA activity,
the device rows without user annotations, `KERNEL_NAMES` to split the
hand-written kernels out, `records_whole`), reading the raw events of a
window rather than averages, so that idle gaps and the kernels inside a
host span can be found. `records_whole` here asks for a kernel and a busy
time within the wall time; a driver that knows how many launches of each
hand-written kernel its window makes holds `count_by_kernel` to them, as
timing.py holds each kernel's count to a multiple of its repetitions. Spans are the benchmark's own
`torch.profiler.record_function` ranges, named `bench.<what>`.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

# a substring of each hand-written kernel's name (csrc/*.cu)
KERNEL_NAMES = {"K1": "tile_forward", "K2": "tile_backward", "K3": "blur"}
SPAN_PREFIX = "bench."


class Interval(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Window(NamedTuple):
    """What a traced window shows."""

    window_s: float
    busy_s: float
    device: list        # [Interval] device operations (kernels, copies, sets)
    spans: list         # [Interval] the benchmark's spans
    host_ops: list      # [Interval] host operators (for naming idle gaps)
    records_whole: bool


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def merged_busy_us(ivs) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, None
    start = None
    for iv in sorted(ivs, key=lambda i: i.start_us):
        if end is None or iv.start_us > end:
            if end is not None:
                total += end - start
            start, end = iv.start_us, iv.end_us
        else:
            end = max(end, iv.end_us)
    if end is not None:
        total += end - start
    return total


class Tracer:
    """Profiles one window of a run: `with tracer.window(): ...`. Off, the
    window and the spans cost nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.result: Window | None = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        self.result = read(prof, wall)


def read(prof, wall_s: float) -> Window:
    device, spans, host = [], [], []
    for e in prof.events():
        iv = Interval(e.name, float(e.time_range.start), float(e.time_range.end))
        if _is_device(e):
            device.append(iv)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append(iv)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(iv)
    busy = merged_busy_us(device) / 1e6
    kernels = [d for d in device if not d.name.startswith("Memcpy")
               and not d.name.startswith("Memset")]
    return Window(wall_s, busy, device, spans, host, bool(kernels) and busy <= wall_s)


def in_spans(device, spans, name: str):
    """The device operations that start inside a span called `name`
    (the run synchronises at the span's ends, so none of them is queued
    by another span)."""
    ranges = [(s.start_us, s.end_us) for s in spans if s.name == SPAN_PREFIX + name]
    return [d for d in device if any(a <= d.start_us <= b for a, b in ranges)]


def seconds_by_kernel(device) -> dict:
    """Device seconds of each of KERNEL_NAMES' kernels and of the rest."""
    out = {k: 0.0 for k in KERNEL_NAMES}
    out["other"] = 0.0
    for d in device:
        key = next((k for k, n in KERNEL_NAMES.items() if n in d.name), "other")
        out[key] += (d.end_us - d.start_us) / 1e6
    return out


def count_by_kernel(device) -> dict:
    """How many records of each of KERNEL_NAMES' kernels `device` holds."""
    return {k: sum(n in d.name for d in device) for k, n in KERNEL_NAMES.items()}


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list and template arguments
    (`void at::native::foo<...>(...)` -> `at::native::foo`), cut to
    `width` characters."""
    out, depth = [], 0
    name = name.replace("(anonymous namespace)", "anon")
    for ch in name.split("(", 1)[0] if not name.startswith("Mem") else name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    s = s[5:] if s.startswith("void ") else s
    return s[:width]


def breakdown(w: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark span and the innermost host operator that
    were running at the gap's middle."""
    by_name: dict = {}
    for d in w.device:
        key = short_name(d.name)
        by_name[key] = by_name.get(key, 0.0) + (d.end_us - d.start_us) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    dev = sorted(w.device, key=lambda d: d.start_us)
    gaps, end = [], None
    for d in dev:
        if end is not None and d.start_us > end:
            gaps.append((end, d.start_us))
        end = d.end_us if end is None else max(end, d.end_us)
    gaps.sort(key=lambda g: g[0] - g[1])

    def name_at(t):
        span = min((s for s in w.spans if s.start_us <= t <= s.end_us),
                   key=lambda s: s.end_us - s.start_us, default=None)
        op = min((h for h in w.host_ops if h.start_us <= t <= h.end_us),
                 key=lambda h: h.end_us - h.start_us, default=None)
        parts = [span.name[len(SPAN_PREFIX):] if span else "outside spans",
                 op.name if op else "no host op"]
        return " / ".join(parts)

    idle = [[name_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:top]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
