"""Named-section wall-clock timing with log_time.txt-format dumps (the
port's own copy of gslivm_tpu/utils/timer.py; `device_memory_mb` reads
`torch.cuda.memory_stats` and `DeviceTrace` runs `torch.profiler`).

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
queues without waiting lands in the next section that waits. Pair them with
`DeviceTrace` for the device timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


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


def device_memory_mb() -> dict:
    """Per-card memory in MB from `torch.cuda.memory_stats` (the caching
    allocator's bytes in use and their peak) — the listen_odom.py
    nvidia-smi analog (python/listen_odom.py:15-60 samples GPU memory per
    odometry frame). {} where there is no card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": round(stats.get("allocated_bytes.all.current", 0) / 2**20, 1),
            "peak_bytes_mb": round(stats.get("allocated_bytes.all.peak", 0) / 2**20, 1),
        }
    return out


class DeviceTrace:
    """torch.profiler trace scope over the host and, where there is a card,
    CUDA activity; on exit writes `<logdir>/trace.json` (chrome trace) —
    the chrome-trace analog the reference lacks (SURVEY §5 'no
    nvtx/chrome-trace'). `self.profile` keeps the profiler for
    key_averages()."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=acts)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.profile.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
        return False
