"""Port parity of the loop profilers, the block-shape sweep and the scaling
tools (CPU): exp_block's binning statistics bit-equal to the JAX package's
bin_instances at every swept shape, crosscheck_blocks on the plain paths,
band_projection's byte counts against the JAX tool's formula,
profile_ingest's stages against its total, scaling_bench at N = 1 and 2 on
gloo ranks, and the timing tools' refusal of the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import binning as jbinning
from gslivm_tpu.ops.rasterize_reference import preprocess as jpreprocess
from gslivm_tpu.ops.rasterize_reference import tile_grid as jtile_grid
from gslivm_tpu_torch.tools import (
    band_projection,
    crosscheck_blocks,
    exp_block,
    profile_ingest,
    profile_iteration,
    scaling_bench,
)

torch.set_num_threads(1)

TOY_N, TOY_W, TOY_H = 3000, 160, 96
TOY_INSTANCES = 1 << 15


@pytest.fixture(scope="module")
def toy_scene():
    return exp_block.bench_scene(TOY_N, TOY_W, TOY_H, device="cpu")


@pytest.mark.parametrize("block", exp_block.BLOCKS)
def test_block_stats_match_jax_binning(toy_scene, block):
    """Expansion, kept instances (the JAX tool's count of gauss_rank >= 0)
    and the busiest tile's chunks equal the JAX package's bin_instances on
    the same scene, at the sweep's chunks and slack; the fitted budgets
    follow tools/exp_block.py:54-56."""
    args, cam = toy_scene
    got = exp_block.block_stats(args, cam, *block, max_instances=TOY_INSTANCES)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    jcam = jmake_camera(np.eye(3), np.zeros(3), TOY_W, TOY_H, fovx=1.2, fovy=0.8)
    b = jbinning.bin_instances(jpreprocess(*jargs, jcam), TOY_W, TOY_H, TOY_INSTANCES,
                               exp_block.STATS_CHUNKS, capacity_slack=exp_block.STATS_SLACK,
                               block_x=block[0], block_y=block[1])
    want = {"expansion": int(b.num_instances), "kept": int(jnp.sum(b.gauss_rank >= 0)),
            "maxch": int(jnp.max(b.tile_nchunks))}
    assert got == want and got["kept"] > 0
    maxi, mc = exp_block.fitted_budgets(got["expansion"], got["maxch"])
    assert maxi == int(np.ceil(got["expansion"] * 1.08 / 128)) * 128
    assert mc == min(64, 2 * got["maxch"])


def test_crosscheck_blocks_on_the_plain_paths(toy_scene):
    """(3, 2) against (2, 2) through the tile path's plain versions: no
    overflow, images and gradients well inside the tool's gates."""
    args, cam = toy_scene
    res = crosscheck_blocks.crosscheck(3, 2, args, cam, ref_instances=TOY_INSTANCES,
                                       alt_instances=TOY_INSTANCES, log=lambda *_: None)
    assert res["overflow"] == [0, 0]
    assert max(res["image_max_abs_diff"].values()) < crosscheck_blocks.IMAGE_TOL
    assert max(res["grad_rel_max_diff"].values()) < crosscheck_blocks.GRAD_TOL


def test_crosscheck_blocks_refuses_a_disagreement(toy_scene, monkeypatch):
    """A block whose render differs past the gate raises."""
    args, cam = toy_scene
    render = crosscheck_blocks.render

    def skewed(a, c, block, maxi, depth_grad=True):
        out = render(a, c, block, maxi, depth_grad)
        return out._replace(acc=out.acc + 1e-3) if tuple(block) != (2, 2) else out

    monkeypatch.setattr(crosscheck_blocks, "render", skewed)
    with pytest.raises(AssertionError, match="disagrees"):
        crosscheck_blocks.crosscheck(2, 4, args, cam, ref_instances=TOY_INSTANCES,
                                     alt_instances=TOY_INSTANCES, log=lambda *_: None)


@pytest.mark.parametrize("n", band_projection.DEVICES)
def test_band_projection_bytes_match_the_jax_formula(n):
    """Band rows, start, budget and the collectives' bytes equal
    tools/band_projection.py:72-100 at 1920x1080, block (2, 2)."""
    bx, by = band_projection.BLOCK
    _, grid_y = jtile_grid(band_projection.WIDTH, band_projection.HEIGHT)
    sgrid_y = -(-grid_y // by)
    band_rows = -(-sgrid_y // n)
    geo = band_projection.band_geometry(n)
    assert geo == {"band_rows": band_rows, "band_start": (sgrid_y - band_rows) // 2,
                   "max_instances": max(1 << 17, int(900_000 // n * 1.4 // 128) * 128)}
    band_px = band_rows * 16 * by * band_projection.WIDTH
    nbytes = band_projection.collective_bytes(n, band_rows)
    assert nbytes["img_bytes"] == 5 * band_px * (n - 1) * 4
    assert nbytes["grad_bytes"] == 2 * 10 * band_projection.N_GAUSS * 4 * (n - 1) / max(n, 1)


def test_profile_ingest_stages_sum_to_the_total():
    """The JAX tool's split (divide + gp + other) and the five stages plus
    the untimed remainder each add up to the frames' total; the remainder
    is a small share of it."""
    a = profile_ingest.build_argparser().parse_args(
        ["--cpu", "--frames", "3", "--width", "48", "--height", "36",
         "--points-per-frame", "2000", "--grid", "0.5"])
    res = profile_ingest.run(a, log=lambda *_: None)
    split, stages = res["split"], res["stages"]
    total = sum(f["ms"] for f in res["frames"]) / 1e3
    assert split["total"] == pytest.approx(total, rel=1e-12)
    assert split["divide"] + split["gp"] + split["other"] == pytest.approx(total, rel=1e-9)
    assert sum(stages.values()) == pytest.approx(total, rel=1e-9)
    assert all(v >= 0 for v in stages.values()) and stages["untimed"] <= 0.5 * total
    assert len(res["frames"]) == 3 and res["frames"][-1]["active"] > 0


def test_scaling_bench_one_and_two_gloo_ranks(capfd):
    """One spawn of two gloo ranks runs N = 1 (a one-rank sub-mesh, rank 1
    waiting) and N = 2 (pixel 2): rank 0 prints a row for each with finite
    times, no overflow and the primitive renderer's phases."""
    rc = scaling_bench.main(["--cpu", "--devices", "1", "2", "--width", "64", "--height", "48",
                             "--gauss", "256", "--iters", "1", "--phases",
                             "--max-instances", "16384"])
    out = capfd.readouterr().out
    assert rc == 0, out
    rows = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == [{"gauss": 1, "pixel": 1}, {"gauss": 1, "pixel": 2}]
    for r in rows:
        assert r["processes"] == 2 and r["overflow"] == 0 and r["device"] == "cpu"
        assert r["ms_per_step"] > 0 and np.isfinite(r["rays_per_s"])
        assert set(r["phases_ms"]) == {"preprocess_exchange", "render_band", "merge_gather",
                                       "bwd_losses_adam", "full_step"}
        assert 0.0 <= r["comm_fraction"] <= 1.0
    assert rows[0]["efficiency_vs_1"] == 1.0


def test_timing_tools_refuse_the_cpu():
    """The tools that time by CUDA events raise for the CPU, never time it."""
    a = profile_iteration.build_argparser().parse_args(["--cpu"])
    for call in (lambda: profile_iteration.run(a, device="cpu"),
                 lambda: exp_block.sweep(device="cpu"),
                 lambda: band_projection.run(device="cpu")):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            call()


def test_tools_raise_without_cuda(monkeypatch):
    """Every new entry point runs on the card by default and raises without
    one, before any work."""
    from gslivm_tpu_torch.tools import quality_bench, quality_diag

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: quality_bench.main([]), lambda: quality_diag.main(["init"]),
                 lambda: profile_iteration.main([]), lambda: profile_ingest.main([]),
                 exp_block.main, lambda: crosscheck_blocks.main([]), band_projection.main,
                 lambda: scaling_bench.main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
