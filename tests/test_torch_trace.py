"""The program's spans (`utils/timer.py`: `span`, `tracing`, `read`,
`reset`) at the layer boundaries of the mapper's frame, and the mapper's
count of the steps that trained on a truncated render. A tiny mapper on
the CPU (the tile rasterizer's plain versions) ingests three frames, then
one frame and one three-camera iteration with the spans off and once more
with them on, each under a CPU profiler."""

import dataclasses
import threading
from types import SimpleNamespace
from typing import NamedTuple

import pytest
import torch

from gslivm_tpu_torch.config import Config, GpParams
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
from gslivm_tpu_torch.pipeline import IncrementalMapper
from gslivm_tpu_torch.utils import timer

torch.set_num_threads(1)

INGEST = ["ingest.divide", "ingest.gp", "ingest.colorize", "ingest.append", "ingest.stage"]
# each span's calls in one add_frame and one three-camera iteration
COUNTS = {"ingest": 1, **{k: 1 for k in INGEST},
          "train": 1, "train.sample": 1, "train.step": 1, "train.feedback": 1,
          "step.render": 3, "step.loss": 4, "step.backward": 1, "step.adam": 1,
          "render.preprocess": 3, "render.binning": 3, "render.table": 6,
          "render.composite": 3, "render.composite_bwd": 3}
# a span's children (on one thread, as the CPU runs the backward)
CHILDREN = {"ingest": INGEST,
            "train": ["train.sample", "train.step", "train.feedback"],
            "train.step": ["step.render", "step.loss", "step.backward", "step.adam"],
            "step.render": ["render.preprocess", "render.binning", "render.table",
                            "render.composite"],
            "step.backward": ["render.composite_bwd"]}


class Range(NamedTuple):
    name: str
    start: int
    end: int


def _profiled_frame(mapper, frame):
    """One add_frame and one train_iteration under a CPU profiler: the
    profiler's raw events as Ranges (read without building its event tree,
    which takes seconds here) and the mapper's step metrics."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mapper.add_frame(frame)
        metrics = mapper.train_iteration()
    events = [Range(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return events, metrics


@pytest.fixture(scope="module")
def runs():
    frames = synthetic.make_sequence(5, 32, 32, points_per_frame=1000, device="cpu")
    cfg = dataclasses.replace(Config(), gp=GpParams(
        grid=0.5, image_sliding_window=1, curr_cam_per_iter=1, history_cam_per_iter=1))
    mapper = IncrementalMapper(
        cfg, settings=RasterizeSettings(backend="tiles", max_instances=4096,
                                        max_chunks_per_tile=4),
        bootstrap_points=200, initial_capacity=4096, device="cpu")
    for f in frames[:3]:
        mapper.add_frame(f)
    timer.tracing(False)
    timer.reset()
    off_events, _ = _profiled_frame(mapper, frames[3])
    off = {"read": timer.read(), "events": off_events,
           "ingest_seconds": dict(mapper.ingest_seconds)}
    timer.tracing(True)
    try:
        on_events, metrics = _profiled_frame(mapper, frames[4])
    finally:
        timer.tracing(False)
    on = {"read": timer.read(), "events": on_events, "metrics": metrics,
          "ingest_seconds": dict(mapper.ingest_seconds)}
    timer.reset()
    return off, on


def test_off_keeps_no_record_and_opens_no_range(runs):
    off, _ = runs
    assert off["read"] == {}
    assert not [e.name for e in off["events"] if e.name.startswith(timer.PREFIX)]
    assert sorted(off["ingest_seconds"]) == sorted(k.split(".")[1] for k in INGEST)
    assert all(v > 0 for v in off["ingest_seconds"].values())


def test_on_counts_each_span_once_a_stage(runs):
    _, on = runs
    assert on["metrics"] is not None
    assert {k: v["count"] for k, v in on["read"].items()} == COUNTS
    # the ingest's seconds are its spans' totals
    assert on["ingest_seconds"] == {k.split(".")[1]: on["read"][k]["total_ns"] / 1e9
                                    for k in INGEST}


@pytest.mark.parametrize("parent", sorted(CHILDREN))
def test_self_time_and_the_childrens_totals_add_up(runs, parent):
    agg = runs[1]["read"]
    kids = sum(agg[k]["total_ns"] for k in CHILDREN[parent])
    assert agg[parent]["self_ns"] + kids == agg[parent]["total_ns"]
    assert 0 <= agg[parent]["self_ns"] < agg[parent]["total_ns"]
    for k in CHILDREN[parent]:
        if k not in CHILDREN:
            assert agg[k]["self_ns"] == agg[k]["total_ns"]


def test_each_span_is_a_profiler_range(runs):
    _, on = runs
    ranges = [e for e in on["events"] if e.name.startswith(timer.PREFIX)]
    counts = {}
    for e in ranges:
        counts[e.name[len(timer.PREFIX):]] = counts.get(e.name[len(timer.PREFIX):], 0) + 1
    assert counts == COUNTS

    def within(inner, outer):
        return [e for e in ranges if e.name == timer.PREFIX + inner
                and any(o.name == timer.PREFIX + outer
                        and o.start <= e.start and e.end <= o.end for o in ranges)]

    assert len(within("render.composite_bwd", "step.backward")) == 3
    assert len(within("render.composite", "step.render")) == 3
    assert len(within("step.render", "train.step")) == 3


def test_a_span_on_another_thread_has_no_parent():
    timer.reset()
    timer.tracing(True)
    try:
        with timer.span("outer"):
            t = threading.Thread(target=_inner)
            t.start()
            t.join()
    finally:
        timer.tracing(False)
    agg = timer.read()
    timer.reset()
    assert agg["inner"]["count"] == 1
    assert agg["outer"]["self_ns"] == agg["outer"]["total_ns"] >= agg["inner"]["total_ns"]


def _inner():
    with timer.span("inner"):
        torch.ones(8).sum()


def test_off_span_fills_the_asked_seconds_only():
    timer.reset()
    secs = {}
    with timer.span("ingest.gp", secs):
        pass
    with timer.span("ingest.divide"):
        pass
    assert list(secs) == ["gp"] and secs["gp"] >= 0
    assert timer.read() == {}


def _row(overflow: int):
    return SimpleNamespace(overflow=torch.tensor(overflow, dtype=torch.int32),
                           num_instances=torch.tensor(70000, dtype=torch.int32),
                           max_nchunks=torch.tensor(3, dtype=torch.int32))


def test_truncated_steps_count_every_row_of_a_packed_read():
    """Rows 1 and 2 overflow: the second escalates the budgets and the
    loop stops feeding the batch to them, but row 3's overflow is still
    counted."""
    mapper = IncrementalMapper(Config(), initial_capacity=8, device="cpu")
    mapper._feedback_hot = False
    mapper.feedback_interval = 4
    for ov in (0, 5, 7, 3):
        mapper._read_feedback(_row(ov))
    assert mapper.overflow_escalations == 1
    assert (mapper.feedback_steps, mapper.truncated_steps) == (4, 3)
    # the escalation made the next read per step
    mapper._read_feedback(_row(0))
    assert (mapper.feedback_steps, mapper.truncated_steps) == (5, 3)
