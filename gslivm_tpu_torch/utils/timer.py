"""Named-section wall-clock timing with log_time.txt-format dumps (the
port's own copy of gslivm_tpu/utils/timer.py), and the program's spans.

Behavioral spec: reference `src/common/timer/timer.{h,cc}` — ~25 named
sections are wrapped across the pipeline via Timer::Evaluate(log_time,
stamp, lambda, name) (timer.h:37-52) accumulating (ms, stamp) pairs;
DumpIntoFile (timer.cc:12-45) writes:

    line 1: realtime ms/frame = duration / camera_size
    line 2: comma-separated section names
    lines 3+: per-call "stamp=ms," columns per section

The format is preserved so the reference's `python/plot_all_time.py`
tooling parses our dumps unchanged. Host timers measure launch + blocking
sections exactly like the reference's CPU-side scoping; CUDA work a section
queues without waiting lands in the next section that waits.

Spans (`span`) mark the layer boundaries of the mapper's frame, named by
layer and stage (`train.step`, `step.backward`, `render.binning`, ...).
They are off until `tracing(True)`: an off span costs one flag check and
keeps nothing. On, each name keeps its count, total host ns and self ns
(the total less its child spans' totals; parents are tracked per thread),
read by `read()` and cleared by `reset()`; while a torch profiler runs, a
span also opens `record_function("gslivm.<name>")`, so the range sits on
the profiler's clock beside the device work it launched.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import torch.autograd.profiler as _profiler


class Timer:
    """Global named-section recorder (class-level like the reference's
    static records map, timer.h:37)."""

    _records: "OrderedDict[str, list[tuple[float, float]]]" = OrderedDict()
    enabled: bool = True

    @classmethod
    @contextlib.contextmanager
    def evaluate(cls, name: str, stamp: float | None = None, log: bool = False):
        """Context-manager twin of Timer::Evaluate."""
        if not cls.enabled:
            yield
            return
        if stamp is None:
            stamp = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            cls._records.setdefault(name, []).append((ms, stamp))
            if log:
                print(f"{name}: {ms:.3f} ms")

    @classmethod
    def record(cls, name: str, ms: float, stamp: float | None = None):
        cls._records.setdefault(name, []).append(
            (ms, stamp if stamp is not None else time.time()))

    @classmethod
    def mean_ms(cls, name: str) -> float:
        rec = cls._records.get(name, [])
        return sum(r[0] for r in rec) / len(rec) if rec else 0.0

    @classmethod
    def summary(cls) -> dict[str, dict]:
        out = {}
        for name, rec in cls._records.items():
            times = [r[0] for r in rec]
            out[name] = {
                "calls": len(times),
                "mean_ms": sum(times) / len(times),
                "max_ms": max(times),
                "total_ms": sum(times),
            }
        return out

    @classmethod
    def dump_into_file(cls, camera_size: int, duration: float, file_name: str):
        """timer.cc:12-45 format (parsed by python/plot_all_time.py)."""
        realtime_ms = duration / max(camera_size, 1)
        with open(file_name, "w") as f:
            f.write(f"{realtime_ms:.9f}\n")
            names = list(cls._records.keys())
            f.write("".join(f"{n}, " for n in names) + "\n")
            max_len = max((len(v) for v in cls._records.values()), default=0)
            for i in range(max_len):
                row = []
                for n in names:
                    rec = cls._records[n]
                    if i < len(rec):
                        ms, stamp = rec[i]
                        row.append(f"{stamp:.15f}={ms:.15f},")
                    else:
                        row.append(",")
                f.write("".join(row) + "\n")

    @classmethod
    def reset(cls):
        cls._records = OrderedDict()


PREFIX = "gslivm."  # the profiler ranges' prefix

_on = False
_lock = threading.Lock()
_local = threading.local()
_stats: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
_OFF = contextlib.nullcontext()


def tracing(on: bool = True):
    """Turn the spans on or off (off by default)."""
    global _on
    _on = bool(on)


def read() -> dict[str, dict[str, int]]:
    """Each span's count, total host ns and self ns since the last reset."""
    with _lock:
        return {k: {"count": c, "total_ns": t, "self_ns": s} for k, (c, t, s) in _stats.items()}


def reset():
    with _lock:
        _stats.clear()


def span(name: str, seconds: dict | None = None):
    """A context manager around one stage called `name`. `seconds`, where
    given, receives the stage's host seconds under the name's last part
    (`ingest.gp` -> seconds["gp"]) whether the spans are on or off."""
    if _on:
        return _Span(name, seconds)
    if seconds is not None:
        return _Clock(name, seconds)
    return _OFF


class _Clock:
    __slots__ = ("key", "seconds", "t0")

    def __init__(self, name: str, seconds: dict):
        self.key, self.seconds = name.rpartition(".")[2], seconds

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.seconds[self.key] = (time.perf_counter_ns() - self.t0) / 1e9


class _Span:
    __slots__ = ("name", "seconds", "parent", "child_ns", "range", "t0")

    def __init__(self, name: str, seconds: dict | None):
        self.name, self.seconds = name, seconds

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        stack.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += ns
        with _lock:
            agg = _stats.setdefault(self.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += ns
            agg[2] += ns - self.child_ns
        if self.seconds is not None:
            self.seconds[self.name.rpartition(".")[2]] = ns / 1e9
