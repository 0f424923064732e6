"""The arithmetic of `benchmark/program_spans.py` on synthetic records: the
twelve per-layer numbers, None on a record without the program's spans or
without a whole trace, and the attribution of device records to the
innermost program range that encloses their launch, across threads by
time."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans as P
from benchmark.trace import Interval

# two iterations of one traced frame, in µs: the calling thread's ranges,
# and render.composite_bwd on autograd's device thread inside step.backward
RANGES = [("train", 0, 100), ("train.sample", 1, 5), ("train.step", 5, 90),
          ("step.render", 6, 30), ("render.composite", 20, 28), ("step.loss", 30, 40),
          ("step.backward", 40, 80), ("render.composite_bwd", 50, 70),
          ("step.adam", 80, 90), ("train.feedback", 90, 99),
          ("train", 200, 300), ("train.step", 205, 290), ("step.render", 206, 230),
          ("render.composite", 220, 228), ("step.loss", 230, 240),
          ("step.backward", 240, 280), ("render.composite_bwd", 250, 270),
          ("step.adam", 280, 290)]
# (kernel key, seconds, launch µs): per iteration, render 2 ms + K1 1 ms,
# loss 1 ms + K3 0.5 ms, backward 3 ms + K2 2 ms + K3 0.5 ms, adam 1 ms, a
# sample copy 0.1 ms; the benchmark's own copy at 150 and one record
# whose launch was not found
RECORDS = [(k, s, t + off) for off in (0, 200) for k, s, t in (
    ("other", 2e-3, 10), ("K1", 1e-3, 25), ("other", 1e-3, 32), ("K3", 5e-4, 35),
    ("other", 3e-3, 45), ("K2", 2e-3, 60), ("K3", 5e-4, 75), ("other", 1e-3, 85),
    ("other", 1e-4, 3))] + [("other", 7e-4, 150), ("other", 1e-5, None)]


def window(n_iter=10):
    ns = {"train": 80e6, "train.sample": 4e6, "train.step": 70e6, "train.feedback": 5e6,
          "step.render": 20e6, "step.loss": 10e6, "step.backward": 30e6, "step.adam": 6e6}
    return {k: {"count": n_iter, "total_ns": int(v * n_iter), "self_ns": 0}
            for k, v in ns.items()}


def record():
    return {"program_spans": {"window": window(), "truncated_steps": 3, "feedback_steps": 40},
            "trace": {"records_whole": True, "iterations": 2},
            "program_trace": P.attribute(RANGES, RECORDS)}


def test_the_twelve_numbers_of_a_record():
    m = P.metrics(record())
    assert list(m) == list(P.HOST) + list(P.BUSY) + ["launches_per_iter.map",
                                                      "truncated_steps.map"]
    assert m["sample_ms.map"] == pytest.approx(4.0)
    assert m["feedback_ms.map"] == pytest.approx(5.0)
    assert m["render_host_ms.map"] == pytest.approx(20.0)
    assert m["loss_host_ms.map"] == pytest.approx(10.0)
    assert m["backward_host_ms.map"] == pytest.approx(30.0)
    assert m["adam_host_ms.map"] == pytest.approx(6.0)
    assert m["render_busy_ms.map"] == pytest.approx(2.0)
    assert m["loss_busy_ms.map"] == pytest.approx(1.0)
    assert m["backward_busy_ms.map"] == pytest.approx(3.0)
    assert m["adam_busy_ms.map"] == pytest.approx(1.0)
    assert m["launches_per_iter.map"] == pytest.approx(9.0)
    assert m["truncated_steps.map"] == pytest.approx(7.5)


@pytest.mark.parametrize("drop", ["program_spans", "trace", "program_trace", "whole"])
def test_none_where_the_record_lacks_the_data(drop):
    rec = record()
    if drop == "whole":
        rec["trace"]["records_whole"] = False
    else:
        del rec[drop]
    m = P.metrics(rec)
    host = [m[k] for k in P.HOST] + [m["truncated_steps.map"]]
    device = [m[k] for k in P.BUSY] + [m["launches_per_iter.map"]]
    assert all(v is None for v in (host if drop == "program_spans" else device))
    assert all(v is not None for v in (device if drop == "program_spans" else host))
    assert all(v is None for v in P.metrics({}).values())


def test_records_go_to_the_innermost_range_across_threads():
    a = P.attribute(RANGES, RECORDS)
    assert a["under"]["step.backward"]["seconds"] == pytest.approx(
        {"other": 6e-3, "K2": 4e-3, "K3": 1e-3})
    assert a["under"]["render.composite_bwd"]["seconds"] == pytest.approx({"K2": 4e-3})
    assert a["under"]["train"]["records"] == 18
    assert a["innermost"]["render.composite"] == pytest.approx(2e-3)
    assert a["innermost"]["step.render"] == pytest.approx(4e-3)
    assert a["unattributed_s"] == pytest.approx(7e-4 + 1e-5)
    assert (a["unattributed_records"], a["unmatched_records"]) == (2, 1)


def test_idle_gaps_by_program_range():
    device = [Interval("k", 0, 2), Interval("k", 12, 14), Interval("k", 160, 161),
              Interval("k", 170, 171)]
    idle = P.idle_by_span(RANGES, device)
    assert idle == pytest.approx({"step.adam": 146e-6, "step.render": 10e-6,
                                  "outside program spans": 9e-6})
    assert list(idle)[0] == "step.adam"
    assert P.idle_by_span([], device) == pytest.approx({"outside program spans": 165e-6})


def _event(name, kind, id_, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=getattr(torch.autograd.DeviceType, kind),
                           id=id_, time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def test_a_device_record_is_launched_by_the_runtime_call_of_its_id():
    """As the card's profiler lists them: ids of host ops and of runtime
    calls overlap, and each range has a device-side twin to leave out."""
    events = [_event("gslivm.train", "CPU", 1, 0, 100, True),
              _event("aten::mul", "CPU", 7, 2, 20),
              _event("cudaLaunchKernel", "CPU", 7, 5, 15),
              _event("void elementwise_kernel<...>", "CUDA", 7, 30, 32),
              _event("gslivm.train", "CUDA", 1, 30, 32, True),
              _event("cudaMemcpyAsync", "CPU", 9, 120, 130),
              _event("Memcpy DtoH (Device -> Pageable)", "CUDA", 9, 131, 133),
              _event("void tile_forward_kernel<...>", "CUDA", 11, 40, 41)]
    ranges, records = P.profile_records(events)
    assert ranges == [("train", 0, 100)]
    assert records == [("other", pytest.approx(2e-6), 5), ("other", pytest.approx(2e-6), 120),
                       ("K1", pytest.approx(1e-6), None)]
