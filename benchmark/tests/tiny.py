"""The cell at a toy size on the CPU, for the tests: the same driver,
checks and limits, with the program's plain CPU paths in place of the
card's kernels."""

from __future__ import annotations

import copy

from benchmark import run as R


def cell(name: str):
    """The cell `name`, cut to a toy size."""
    c = R.Cell(R.load_json(R.ROOT, "BENCHMARK.json"), name)
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.cell)
    cfg["bootstrap_points"] = 30
    cfg["program"]["gp"]["image_sliding_window"] = 3
    cfg["program"]["gp"]["grid"] = 0.6
    cfg["camera"].update(image_width=64, image_height=48, fx=cfg["camera"]["fx"] / 15,
                         fy=cfg["camera"]["fy"] / 12.5)
    cfg["lidar"].update(sweep_points=6000, voxel_size=0.15)
    tr["path"]["period_s"] = 0.6
    tr.update(iters_per_frame=1, setup_keyframes=5, check_iters=3, trace_frames=0)
    c.config, c.cell = cfg, tr
    return c


def run(name: str, seed: int = 12345678901, seconds: float = 0.0, control: bool = False):
    """One run of the toy cell on the CPU: (its record, its result line)."""
    c = cell(name)
    ctx = R.Context(c, seed, seconds, False, device="cpu", control=control,
                    log=lambda *a: None)
    rec = R.run(c, ctx)
    return rec, R.result_line(c, ctx, rec, {"platform": "cpu"})
