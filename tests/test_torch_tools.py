"""Port parity of the measurement and offline tools (CPU): T1's and T2's
plain versions against the JAX tools' Pallas kernels in interpret mode,
the kernel-cost tool's fabricated case, memlog and the evaluate CLI against
their JAX twins, and the device timer's refusal to time the CPU."""

import functools
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gslivm_tpu.tools import evaluate as jevaluate
from gslivm_tpu.tools import memlog as jmemlog
from gslivm_tpu.utils.outputs import save_png
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.ops import rasterize_tiles as ttiles
from gslivm_tpu_torch.tools import evaluate as tevaluate
from gslivm_tpu_torch.tools import memlog as tmemlog
from gslivm_tpu_torch.tools import microbench_fwdablate as tablate
from gslivm_tpu_torch.tools import microbench_kernelcost as tcost
from gslivm_tpu_torch.tools import microbench_roll as troll
from gslivm_tpu_torch.tools import timing

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def _load_jax_tool(name: str):
    """Import tools/<name>.py. Importing it points JAX's persistent
    compilation cache at the repo and puts tools/ on sys.path; both are put
    back at once, since an xdist worker runs other test files in this
    process."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path


jroll = _load_jax_tool("microbench_roll")
jablate = _load_jax_tool("microbench_fwdablate")


def test_loading_the_jax_tools_leaves_jax_config_alone():
    assert jax.config.jax_compilation_cache_dir is None or ".jax_cache" not in str(
        jax.config.jax_compilation_cache_dir)
    assert str(TOOLS) not in sys.path


@pytest.mark.parametrize("variant", troll.VARIANTS)
def test_t1_plain_matches_pallas_interpret(variant):
    """The fetch-sum of every variant against the JAX tool's kernel on 3
    tiles; A at aligned offsets, B-D at unaligned ones (f32 sums of 4,096
    squares in another order: 1e-5 relative)."""
    tiles, feat, chunk = 3, troll.FEAT, troll.CHUNK
    off = np.asarray([0, 256, 512] if variant == "A" else [0, 200, 333], np.int32)
    nch = np.asarray([2, 1, 2], np.int32)
    rng = np.random.default_rng(3)
    inst = rng.standard_normal((feat, 333 + 2 * chunk + 2 * chunk)).astype(np.float32)
    width = chunk if variant == "A" else 2 * chunk
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i, *_: (i, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, feat, width), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    f = pl.pallas_call(functools.partial(jroll.kernel, variant), grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((tiles, 8, 128), jnp.float32),
                       interpret=True)
    want = np.asarray(f(jnp.asarray(off), jnp.asarray(nch), jnp.asarray(inst)))
    assert (want == want[:, :1, :1]).all()  # the sum broadcast over the block
    got = troll.fetch_sum(convert.inst_from_numpy(inst, device="cpu"),
                          torch.from_numpy(off), torch.from_numpy(nch), variant)
    np.testing.assert_allclose(got.numpy(), want[:, 0, 0], rtol=1e-5)


@pytest.mark.parametrize("variant", ["A", "B"])
def test_t1_inputs_are_the_jax_tools(variant, monkeypatch):
    """make_inputs draws what the JAX tool's run() draws (its T shrunk)."""
    monkeypatch.setattr(jroll, "T", 5)
    monkeypatch.setattr(jroll, "MAXI", 5 * jroll.NCH * jroll.CHUNK + 2 * jroll.CHUNK)
    captured = {}
    monkeypatch.setattr(jroll.pl, "pallas_call", lambda *a, **k: (lambda *x: x))
    monkeypatch.setattr(jroll, "report", lambda name, g, off, nch, inst: captured.update(
        off=np.asarray(off), nch=np.asarray(nch), inst=np.asarray(inst)))
    jroll.run(variant)
    inst, off, nch = troll.make_inputs(variant, tiles=5)
    np.testing.assert_array_equal(inst, captured["inst"])
    np.testing.assert_array_equal(off, captured["off"])
    np.testing.assert_array_equal(nch, captured["nch"])


def test_t1_rows_outside_the_table_count_zero():
    inst = torch.ones((300, 16))
    got = troll.fetch_sum(inst, torch.tensor([0, 200, -100], dtype=torch.int32),
                          torch.tensor([2, 1, 1], dtype=torch.int32), "D")
    assert got.tolist() == [256 * 16.0, 100 * 16.0, 28 * 16.0]


@pytest.mark.parametrize("variant", tablate.VARIANTS)
def test_t2_plain_matches_pallas_interpret(variant, monkeypatch):
    """Every ablation variant against the JAX tool's kernel on a 2x1 grid
    of 32x32 tiles with 2 chunks each (the same f32 formula: 1e-5 of each
    row's scale)."""
    monkeypatch.setattr(jablate, "GX", 2)
    monkeypatch.setattr(jablate, "GY", 1)
    monkeypatch.setattr(jablate, "NCH", 2)
    inst, start, nch, cnt = jablate.build_inputs()
    mine = tablate.build_inputs(2, 1, 2)
    for a, b in zip(mine, (inst, start, nch, cnt)):
        np.testing.assert_array_equal(a, np.asarray(b))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3, grid=(2,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
        out_specs=pl.BlockSpec((1, 8, tablate.NPIX), lambda i, *_: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, tablate.FEAT, 2 * 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))])
    flags = frozenset() if variant == "full" else frozenset({variant})
    f = pl.pallas_call(functools.partial(jablate.kernel, flags), grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((2, 8, tablate.NPIX), jnp.float32),
                       interpret=True)
    want = np.asarray(f(start, nch, cnt, inst))
    got = tablate.chunk_walk(*tablate.device_inputs("cpu", gx=2, gy=1, nch=2), 2,
                             variant).numpy()
    assert got.shape == want.shape == (2, 8, tablate.NPIX)
    for row in range(8):
        scale = max(float(np.abs(want[:, row]).max()), 1.0)
        assert float(np.abs(got[:, row] - want[:, row]).max()) <= 1e-5 * scale, row
    if variant in ("full", "noscan"):
        assert float(want[:, 4].max()) > 0.5  # the case composites something


def test_t2_bound_counts_the_walked_pairs():
    _, start, nch, cnt = tablate.build_inputs()
    w = tablate.work(torch.from_numpy(nch), torch.from_numpy(cnt))
    assert w["pairs"] == 2040 * 512 * 1024
    assert w["bound_by"] == "operations"
    assert abs(w["bound_ms"] - 0.2393) < 1e-3


def test_wrappers_refuse_unknown_variants_and_ragged_grids():
    inst = torch.zeros((256, 16))
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        troll.fetch_sum(inst, i32, i32, "E")
    with pytest.raises(ValueError, match="variant"):
        tablate.chunk_walk(inst, i32, i32, i32, 2, "nothing")
    with pytest.raises(ValueError, match="grid_x"):
        tablate.chunk_walk(inst, i32, i32, i32, 3, "full")


@pytest.mark.parametrize("nch", [1, 2])
def test_kernelcost_case_walks_every_chunk(nch):
    """The fabricated case at a tiny size: every tile walks all its chunks
    (the plain K1 on the CPU), forward and through the autograd render."""
    table, binned, cfg = tcost.fabricated_case(nch, "cpu", grid=(2, 1), num_gaussians=500)
    assert table.shape == (16, 500) and cfg.rect_test and not cfg.contrib_stats
    assert int(binned.gid_sorted.shape[0]) == 2 * nch * 128 + 256
    leaf = table.clone().requires_grad_(True)
    tiles = ttiles.render_from_table(leaf, binned, cfg, False)
    tcost.check_full_walk(tiles.detach(), nch)
    (g,) = torch.autograd.grad(tcost.loss_of(tiles), leaf)
    assert bool(torch.isfinite(g).all()) and float(g[ttiles._FR].abs().max()) > 0
    with pytest.raises(AssertionError, match="stopped"):
        tcost.check_full_walk(tiles.detach(), nch + 1)


def test_kernelcost_split_recovers_a_line():
    rows = [{"chunks": c, "t": 0.5 + 2e-3 * c} for c in (2040, 16320)]
    fit = tcost.split(rows, "t", tiles=2040)
    assert abs(fit["slope_us_per_chunk"] - 2.0) < 1e-9
    assert abs(fit["per_tile_us"] - 500.0 / 2040) < 1e-9


def test_memlog_csv_matches_jax(tmp_path):
    paths = []
    for mod, name in ((jmemlog, "j.csv"), (tmemlog, "t.csv")):
        kw = {} if mod is jmemlog else {"device": "cpu"}
        log = mod.MemoryLogger(str(tmp_path / name), **kw)
        assert log.sample(stamp=1.0) == 0.0
        log.sample(stamp=2.5)
        paths.append(tmp_path / name)
    assert paths[0].read_text() == paths[1].read_text() == "1.000000,0.000\n2.500000,0.000\n"
    assert jmemlog.device_memory_mb(jax.devices("cpu")[0]) == 0.0
    assert tmemlog.device_memory_mb("cpu") == 0.0


def test_memlog_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmemlog.device_memory_mb()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmemlog.MemoryLogger(str(tmp_path / "m.csv"))


def _cli_json(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _assert_same_json(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            # f32 means over ~2,300 terms summed in another order than
            # XLA's: 1e-5 of PSNR (dB), 1e-5 absolute on L1, SSIM and the
            # inverse-depth gap, which lie in [0, 1]
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cmd", ["split", "dirs", "depth"])
def test_evaluate_cli_matches_jax(cmd, tmp_path, capsys):
    rng = np.random.default_rng(8)
    for d in ("sbs", "r", "g"):
        (tmp_path / d).mkdir()
    for i in range(2):
        r = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        g = np.clip(r.astype(int) + rng.integers(-30, 30, r.shape), 0, 255).astype(np.uint8)
        save_png(str(tmp_path / "sbs" / f"{i}.png"), np.concatenate([r, g], axis=1))
        save_png(str(tmp_path / "r" / f"{i}.png"), r)
        save_png(str(tmp_path / "g" / f"{i}.png"), g)
    np.save(tmp_path / "a.npy", rng.uniform(0, 5, (16, 16)).astype(np.float32))
    np.save(tmp_path / "b.npy", rng.uniform(0, 5, (16, 16)).astype(np.float32))
    args = {"split": [str(tmp_path / "sbs")],
            "dirs": [str(tmp_path / "r"), str(tmp_path / "g")],
            "depth": [str(tmp_path / "a.npy"), str(tmp_path / "b.npy")]}[cmd]
    want = _cli_json(jevaluate.main, [cmd, *args], capsys)
    got = _cli_json(tevaluate.main, [cmd, *args, "--device", "cpu"], capsys)
    _assert_same_json(want, got)
    if cmd != "depth":
        assert got["count"] == 2 and got["mean_lpips"] is None is want["mean_lpips"]


@pytest.mark.parametrize("timer", [timing.device_time_ms, timing.graph_time_ms,
                                   timing.device_busy_ms])
def test_device_timers_refuse_the_cpu(timer, monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        timer(lambda: None, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        timing.report("cpu", lambda: None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        timer(lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CPU tensor"):
        timer(torch.sin, torch.zeros(3))


def test_inst_from_numpy_is_row_major_and_contiguous():
    fm = np.arange(16 * 5, dtype=np.float64).reshape(16, 5)
    t = convert.inst_from_numpy(fm, device="cpu")
    assert t.dtype == torch.float32 and t.shape == (5, 16) and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), fm.T)
