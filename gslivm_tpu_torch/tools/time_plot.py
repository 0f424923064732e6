"""Per-stage timing + device-memory plot (the port's own copy of
gslivm_tpu/tools/time_plot.py; python/plot_all_time.py parity). matplotlib
is imported when a plot is drawn; the card machine has none.

Reads the log_time.txt dump written by utils.timer (same format as the
reference's timer.cc:12-45) and an optional memory log (CSV `stamp,mb` —
the listen_odom.py nvidia-smi analog, here fed by tools.memlog), and
renders a stacked per-stage latency area chart with a real-time budget
line and a memory curve on a twin axis.
"""

from __future__ import annotations

import argparse

import numpy as np


def load_memory_log(path: str) -> tuple[np.ndarray, np.ndarray]:
    data = np.loadtxt(path, delimiter=",").reshape(-1, 2)
    return data[:, 0], data[:, 1]


def plot_log_time(log_path: str, out_path: str, mem_path: str | None = None,
                  realtime_ms: float | None = None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.metrics import parse_log_time

    parsed = parse_log_time(log_path)
    sections = parsed["sections"]
    budget = realtime_ms if realtime_ms is not None else parsed["realtime_ms"]

    # Union of stamps across sections; each section contributes its ms at
    # its own stamps (0 elsewhere) — stacked like the reference's
    # fill_between loop (plot_all_time.py:120-141).
    stamps = sorted({s for recs in sections.values() for s, _ in recs})
    if not stamps:
        raise ValueError(f"no timing records in {log_path}")
    t0 = stamps[0]
    x = np.asarray(stamps) - t0
    fig, ax1 = plt.subplots(figsize=(12, 7))
    bottom = np.zeros(len(x))
    cmap = plt.colormaps["tab20"]
    for i, (name, recs) in enumerate(sorted(sections.items())):
        lookup = {s: ms for s, ms in recs}
        y = np.asarray([lookup.get(s, 0.0) for s in stamps])
        ax1.fill_between(x, bottom, bottom + y, color=cmap(i % 20),
                         alpha=0.6, label=name)
        bottom += y
    ax1.axhline(budget, color="red", linestyle="--", lw=2,
                label=f"real-time budget ({budget:.1f} ms)")
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("per-stage latency (stacked) [ms]")

    if mem_path:
        mt, mb = load_memory_log(mem_path)
        ax2 = ax1.twinx()
        ax2.plot(mt - t0, mb, color="blue", linestyle="--", lw=1.2,
                 label="device memory")
        ax2.set_ylabel("device memory [MB]")
        ax2.set_ylim(bottom=0)

    ax1.legend(loc="upper left", fontsize=7, ncol=2)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("log_time")
    ap.add_argument("--mem-log", default=None)
    ap.add_argument("--out", default="all_time.png")
    ap.add_argument("--realtime-ms", type=float, default=None)
    args = ap.parse_args(argv)
    print(plot_log_time(args.log_time, args.out, args.mem_log,
                        args.realtime_ms))


if __name__ == "__main__":
    main()
