"""The harness: BENCHMARK.json to its schema, every name found
by name (configurations, cells, drivers, per-layer readers), the last
line's keys in order, the refusal without a card, and a cell and a
metric added as new files and entries to a copy, with no file edited."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return R.load_json(ROOT, "BENCHMARK.json")


def test_the_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(p == "benchmark" or p.startswith("benchmark/") for p in bench["paths"])
    assert len(json.dumps(bench)) < 64 * 1024
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    names = [c["name"] for c in bench["workloads"]]
    assert len(names) == len(set(names))
    assert len({(c["config"], c["traffic"]) for c in bench["workloads"]}) == len(names)


@pytest.mark.parametrize("name", [w["name"] for w in R.load_json(ROOT, "BENCHMARK.json")
                                  ["workloads"]])
def test_each_cell_is_found_by_name(name, bench):
    cell = R.Cell(bench, name)
    __import__("benchmark.drivers." + cell.driver_name)
    assert cell.workload["chips"] == 1
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in cell.per_layer():
        reader = R.load_file(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"),
                             "m_" + m["name"].replace(".", "_"))
        assert reader.read({}) is None  # nothing to read: the metric is left out
        assert m["moves"] in e2e
    assert set(cell.cell["limits"])


def test_the_last_line_has_its_keys_in_order_and_the_checks_last(bench):
    cell = R.Cell(bench, bench["workloads"][0]["name"])
    ctx = R.Context(cell, 1, 1.0, False, device="cpu")
    e2e = {m["name"]: 1.5 for m in cell.end_to_end()}
    rec = {"metrics": e2e, "attempted": 3, "failed": 0, "memory_peak_bytes": 0,
           "checks": [{"name": "a_gap", "value": 0.5, "limit": 1.0}]}
    line = R.result_line(cell, ctx, rec, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    rec["checks"][0]["value"] = float("nan")
    assert R.result_line(cell, ctx, rec, {})["correct"] is False


def run_cli(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_without_a_card_a_run_prints_no_result(bench):
    p = run_cli(ROOT, "--workload", bench["workloads"][0]["name"], "--seed", str(2**40 + 7),
                "--seconds", "1", "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""


def test_without_the_program_a_run_fails(bench, tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_cli(tmp_path, "--workload", bench["workloads"][0]["name"], "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


TOY_DRIVER = '''
def run(ctx):
    return {"metrics": {"setup_s": 0.25, "toy_rate": 2.0 * ctx.traffic["rate"]},
            "attempted": 4, "failed": 0, "memory_peak_bytes": 0, "toy_count": 7,
            "checks": [{"name": "toy_gap", "value": 0.0, "limit": 0.0}]}
'''
TOY_METRIC = '''
def read(rec):
    return rec.get("toy_count")
'''


def test_a_cell_and_a_metric_are_added_as_files_and_entries(bench, tmp_path):
    """A toy configuration, cell, driver and per-layer metric in a copy:
    new files and new entries of BENCHMARK.json, and no file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(tmp_path / "benchmark") for p in fs}
    b = json.loads(json.dumps(bench))
    (tmp_path / "benchmark" / "configs" / "toy.json").write_text('{"name": "toy"}')
    (tmp_path / "benchmark" / "cells" / "toy.cell.json").write_text(
        '{"driver": "toy", "rate": 3.0, "limits": {"toy_gap": 0.0}}')
    (tmp_path / "benchmark" / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (tmp_path / "benchmark" / "metrics" / "toy_count.cell.py").write_text(TOY_METRIC)
    b["configs"].append({"name": "toy", "source": "a test", "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "toy.cell", "config": "toy", "traffic": "toy", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].append({"name": "toy_rate", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["toy.cell"]})
    b["per_layer"].append({"name": "toy_count.cell", "unit": "1", "better": "lower",
                           "source": "program_counter", "layer": "toy", "moves": "toy_rate",
                           "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = ("import json, sys; from benchmark import run as R; "
            "b = R.load_json('.', 'BENCHMARK.json'); c = R.Cell(b, 'toy.cell', root='.'); "
            "out = []\n"
            "for t in (0, 1):\n"
            "    ctx = R.Context(c, 5, 1.0, bool(t), device='cpu')\n"
            "    out.append(R.result_line(c, ctx, R.run(c, ctx), {}))\n"
            "print(json.dumps(out))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    e2e, layer = json.loads(p.stdout.strip().splitlines()[-1])
    assert e2e["metrics"] == {"setup_s": {"value": 0.25, "unit": "s"},
                              "toy_rate": {"value": 6.0, "unit": "1/s"}}
    assert layer["metrics"] == {"toy_count.cell": {"value": 7.0, "unit": "1"}}
    assert e2e["correct"] and layer["correct"]
    for p_, data in before.items():
        matches = [os.path.join(dp, p_) for dp, _, fs in os.walk(tmp_path / "benchmark")
                   if p_ in fs]
        assert any(open(m, "rb").read() == data for m in matches)
