"""Arithmetic the per-layer metric readers share. A reader returns None
where its record holds nothing to read, and the harness then leaves the
metric out of the line."""

from __future__ import annotations

import statistics


def mean_ms(rec: dict, span: str):
    vals = rec.get("spans", {}).get(span)
    return statistics.fmean(vals) * 1e3 if vals else None


def idle_share(rec: dict):
    """100 (1 - busy / wall) over the traced window."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or not t["records_whole"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(rec: dict, kernel: str):
    """100 x the kernel's bound over its profiler time in the traced
    window; None without a whole trace or without the kernel in it."""
    t = rec.get("trace")
    if not t or not t["records_whole"]:
        return None
    secs = t["kernel_s"].get(kernel, 0.0)
    if secs <= 0 or t["bound_s"].get(kernel, 0.0) <= 0:
        return None
    return 100.0 * t["bound_s"][kernel] / secs


def other_busy_ms(rec: dict, per: str):
    """Device ms outside K1/K2/K3 per unit of work (`per` counts it)."""
    t = rec.get("trace")
    if not t or not t["records_whole"] or not t.get(per):
        return None
    return 1e3 * t["other_busy_s"] / t[per]
