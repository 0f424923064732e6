"""The check that decides `correct`, driven through whole runs of the
cell at a toy size on the CPU (the harness's look for a card skipped):
a sound run passes; the control (the reference in bfloat16 in the
program's place) and each fault the cell can have, planted in the timed
path, fail it."""

from __future__ import annotations

import pytest
import torch

from benchmark import faults
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_a_sound_run_is_correct():
    rec, line = tiny.run("botanic.map")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["checks"]["append_xyz_unmatched"]["value"] == 0
    assert rec["program"]["check_cameras"] == 3  # the steady step: current + history pair


def test_the_control_is_not_correct():
    rec, line = tiny.run("botanic.map", control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    rec, line = tiny.run("botanic.map")
    assert not line["correct"], line["checks"]
