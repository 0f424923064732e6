"""Port parity of the stage profilers (CPU): profile_stages' cuts against
the JAX package's preprocess, binning, rank table and naive rasterizer;
profile_binning's mirrored cuts against the port's bin_instances, bit for
bit, at every swept block shape; microbench_losses' functions against
gslivm_tpu.ops.losses; microbench_gridsample's variants against the JAX
tool's taps4; and the tools' refusal of the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import binning as jbinning
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu.ops import rasterize as jras
from gslivm_tpu.ops import rasterize_pallas as jrp
from gslivm_tpu.ops.rasterize_reference import preprocess as jpreprocess
from gslivm_tpu_torch.ops import binning, losses, rasterize_reference
from gslivm_tpu_torch.ops.blur import blur_plain
from gslivm_tpu_torch.tools import (
    exp_block,
    microbench_gridsample,
    microbench_losses,
    profile_binning,
    profile_stages,
)

torch.set_num_threads(1)

TOY_N, TOY_W, TOY_H = 500, 64, 48
# the tool's chunks, slack and block; an instance budget for the toy scene
TOY_BUDGETS = {**profile_stages.BUDGETS, "max_instances": 1 << 12}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(a, b):
    """max |a - b| over max |b| (b the reference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    """(port args, port camera, JAX args, JAX camera) of the toy bench scene."""
    args, cam = exp_block.bench_scene(TOY_N, TOY_W, TOY_H, device="cpu")
    jcam = jmake_camera(np.eye(3), np.zeros(3), TOY_W, TOY_H, fovx=1.2, fovy=0.8)
    return args, cam, [jnp.asarray(a.numpy()) for a in args], jcam


@pytest.fixture(scope="module")
def jax_pre(scene):
    return jax.jit(lambda *a: jpreprocess(*a, scene[3]))(*scene[2])


@pytest.fixture(scope="module")
def jax_binned(jax_pre):
    """JAX's bin_instances of jax_pre at TOY_BUDGETS."""
    kw = TOY_BUDGETS
    return jax.jit(lambda p: jbinning.bin_instances(
        p, TOY_W, TOY_H, kw["max_instances"], kw["max_chunks_per_tile"],
        capacity_slack=kw["capacity_slack"], block_x=kw["block_x"], block_y=kw["block_y"],
        aligned_layout=False))(jax_pre)


def test_stage_preprocess_and_binning_match_jax(scene, jax_pre, jax_binned):
    """The `preprocess` cut within 1e-5 relative of JAX's (integer fields
    equal), and the `+ binning` cut's integers bit-equal to JAX's
    bin_instances at the tool's chunks, slack and block; the statistics
    read the same binning and do not overflow."""
    args, cam, _, _ = scene
    pre = profile_stages.s_pre(args, cam, TOY_BUDGETS)
    for f in rasterize_reference.PreprocessedGaussians._fields:
        got, want = _np(getattr(pre, f)), np.asarray(getattr(jax_pre, f))
        if got.dtype.kind == "f":
            assert _scaled_err(got, want) <= 1e-5, f
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    b = profile_stages.s_bin(args, cam, TOY_BUDGETS)
    jb = jax_binned
    for f in binning.BinnedInstances._fields:
        np.testing.assert_array_equal(_np(getattr(b, f)), np.asarray(getattr(jb, f)), err_msg=f)
    stats = profile_stages.instance_stats(args, cam, TOY_BUDGETS)
    assert stats["overflow"] == 0 and stats["kept"] == int(b.cnt_allowed.sum()) > 0
    assert stats["expansion"] == int(jb.num_instances)
    assert stats["chunks_max"] == int(jnp.max(jb.tile_nchunks)) <= TOY_BUDGETS[
        "max_chunks_per_tile"]
    assert stats["padded_capacity"] == jbinning._padded_capacity(
        TOY_BUDGETS["max_instances"], b.tile_nchunks.shape[0], TOY_BUDGETS["capacity_slack"])


def test_stage_feature_pack_matches_jax(scene, jax_pre, jax_binned):
    """The `+ feature pack` cut on JAX's preprocessed gaussians: its rank
    table and the instances gathered into sorted-slot order within 1e-6
    of JAX's _build_rank_table and its column gather."""
    pre = rasterize_reference.PreprocessedGaussians(
        *(torch.from_numpy(np.array(x)) for x in jax_pre))
    inst, b, cfg, table = profile_stages.pack_pre(pre, scene[1], TOY_BUDGETS)
    jb = jax_binned
    jtable = jax.jit(lambda p, d: jrp._build_rank_table(p, d, rect_rows=True))(
        jax_pre, jb.dorder)
    assert table.shape == jtable.shape and cfg.rect_test
    assert float(np.abs(_np(table) - np.asarray(jtable)).max()) <= 1e-6
    jinst = np.asarray(jtable[:, jb.gid_sorted]).T
    assert inst.shape == jinst.shape
    assert float(np.abs(_np(inst) - jinst).max()) <= 1e-6


def test_stage_full_loss_and_grads_match_jax_naive(scene):
    """`full fwd (loss)` and `FULL fwd+bwd` on the tile path's plain
    versions against JAX's naive rasterizer: the loss and the five
    gradients within 1e-3 of scale (bench.py:220-228's gate). The
    kernel-only gradients equal the backward cuts' (K2, then autograd to
    the five parameters) fed that loss's tile cotangent, and the forward
    kernel cut renders the tiles they start from."""
    args, cam, jargs, jcam = scene

    def jloss(*a):
        out = jras.rasterize(*a, jcam, settings=jras.RasterizeSettings(backend="naive"))
        return jnp.sum(out.color ** 2) + 0.1 * jnp.sum(out.acc)

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4)))(*jargs)
    assert _scaled_err(_np(profile_stages.full_loss(args, cam, TOY_BUDGETS)), jv) <= 1e-3
    grads = profile_stages.full_grads(args, cam, TOY_BUDGETS)
    for name, g, want in zip(("means", "scales", "quats", "opac", "shs"), grads, jg):
        assert _scaled_err(_np(g), want) <= 1e-3, name

    def kernel_cotangent(tiles):
        return torch.cat([2.0 * tiles[:, :5], torch.zeros_like(tiles[:, 5:])], dim=1)

    st = profile_stages.bwd_state(args, cam, TOY_BUDGETS, cotangent=kernel_cotangent)
    for got, want in zip(profile_stages.s_bwd_params(st),
                         profile_stages.kernel_grads(args, cam, TOY_BUDGETS)):
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(profile_stages.s_fwd(args, cam, TOY_BUDGETS), st["out"],
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def bench_pre():
    args, cam = exp_block.bench_scene(3000, 160, 96, device="cpu")
    with torch.no_grad():
        return rasterize_reference.preprocess(*args, cam), cam


@pytest.mark.parametrize("block", exp_block.BLOCKS)
def test_binning_mirror_equals_bin_instances(bench_pre, block, monkeypatch):
    """profile_binning's mirrored cuts against the port's bin_instances at
    the tool's chunks and slack: the depth order and the expansion equal,
    the key before the sort and the sorted keys equal the ones
    bin_instances sorts bit for bit, so the gid_sorted and tile runs read
    off `+ sort` are bin_instances' own."""
    pre, cam = bench_pre
    maxi = 1 << 12
    geo = profile_binning.Geometry(cam.width, cam.height, maxi, *block)
    cut = profile_binning.upto_sort(pre, geo)
    sorts, sort = [], torch.sort

    def spy(x, *a, **kw):
        out = sort(x, *a, **kw)
        sorts.append((x, out.values))
        return out

    monkeypatch.setattr(torch, "sort", spy)
    b = binning.bin_instances(pre, cam.width, cam.height, maxi, profile_binning.MAXCH,
                              capacity_slack=profile_binning.SLACK, block_x=block[0],
                              block_y=block[1])
    monkeypatch.undo()
    (key, key_sorted), = sorts
    assert torch.equal(cut["dorder"].int(), b.dorder)
    assert int(cut["total"]) == int(b.num_instances) > 0
    assert torch.equal(cut["key"], key)
    assert torch.equal(cut["key_sorted"], key_sorted[:maxi])
    assert torch.equal((cut["key_sorted"] & 0xFFFFFFFF).int(), b.gid_sorted)
    bounds = torch.searchsorted(cut["key_sorted"] >> 32, torch.arange(geo.num_tiles + 1))
    assert torch.equal(bounds[:-1].int(), b.sorted_start)
    assert int((cut["tile_id"] < geo.num_tiles).sum()) < int(cut["total"])  # the cull drops some


def test_loss_functions_match_jax():
    """microbench_losses' functions against gslivm_tpu.ops.losses on the
    tool's images (48x64): ssim (K3's plain version), the F.conv2d SSIM,
    the five separate blur chains, l1, image_loss and psnr within 1e-6; the
    separate and the F.conv2d SSIM gradients within 1e-6 of scale of the
    stacked one's; the [15, H, W] stack, blurred, gives the stacked SSIM."""
    a, b = microbench_losses.images(48, 64, device="cpu")
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jssim, jl1, jimage, jpsnr = jax.jit(lambda x, y: (
        1.0 - jlosses.ssim(x, y), jlosses.l1_loss(x, y), jlosses.image_loss(x, y),
        jlosses.psnr(x, y)))(ja, jb)
    pairs = {"ssim": (microbench_losses.ssim_loss, jssim),
             "ssim_conv2d": (microbench_losses.ssim_conv2d, jssim),
             "ssim_separate": (microbench_losses.ssim_separate, jssim),
             "l1": (losses.l1_loss, jl1),
             "image_loss": (losses.image_loss, jimage),
             "psnr": (losses.psnr, jpsnr)}
    for name, (fn, want) in pairs.items():
        assert abs(float(fn(a, b)) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0), name
    grads = [microbench_losses.grad_of(fn)(a, b) for fn in (
        microbench_losses.ssim_loss, microbench_losses.ssim_separate,
        microbench_losses.ssim_conv2d)]
    assert float(grads[0].abs().max()) > 0
    for g in grads[1:]:
        assert _scaled_err(_np(g), _np(grads[0])) <= 1e-6
    taps = losses.gaussian_1d()
    parts = blur_plain(microbench_losses.ssim_stack(a, b), taps).split(3)
    assert float(microbench_losses._ssim_from(*parts)) == float(microbench_losses.ssim_loss(a, b))


def _jax_taps4(img, x, y):
    """tools/microbench_gridsample.py:34-51, the JAX tool's four taps."""
    H, W = img.shape
    x0, y0 = jnp.floor(x), jnp.floor(y)
    wx, wy = x - x0, y - y0

    def tap(yy, xx):
        inside = (xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)
        xi = jnp.clip(xx, 0, W - 1).astype(jnp.int32)
        yi = jnp.clip(yy, 0, H - 1).astype(jnp.int32)
        return jnp.where(inside, img[yi, xi], 0.0)

    return (tap(y0, x0) * (1 - wx) * (1 - wy) + tap(y0, x0 + 1) * wx * (1 - wy)
            + tap(y0 + 1, x0) * (1 - wx) * wy + tap(y0 + 1, x0 + 1) * wx * wy)


def test_gridsample_variants_match_the_jax_taps():
    """Every variant's values and image gradient against the JAX tool's
    taps4 at the same points, and against each other, within 1e-6 of
    scale; the points include footprints partly and wholly outside."""
    inputs = microbench_gridsample.make_inputs(48, 64, device="cpu")
    img, x, y, _, _ = inputs
    assert bool((x < -1).any() & (x > 64).any() & (y < 0).any() & (y > 47).any())
    jimg, jx, jy = (jnp.asarray(t.numpy()) for t in (img, x, y))
    want = {" fwd": np.asarray(jax.jit(_jax_taps4)(jimg, jx, jy)),
            " fwd+bwd(img)": np.asarray(jax.jit(jax.grad(
                lambda i: _jax_taps4(i, jx, jy).sum()))(jimg))}
    for name, fn, args in microbench_gridsample.cuts(*inputs):
        kind = name[name.index(" fwd"):]
        assert _scaled_err(_np(fn(*args)), want[kind]) <= 1e-6, name
    diffs = microbench_gridsample.max_scaled_diffs(*inputs)
    assert len(diffs) == 8 and max(diffs.values()) <= microbench_gridsample.TOL


STAGE_TOOLS = (profile_stages, profile_binning, microbench_losses, microbench_gridsample)


@pytest.mark.parametrize("tool", STAGE_TOOLS, ids=lambda t: t.__name__.rsplit(".", 1)[1])
def test_stage_tools_refuse_the_cpu(tool, monkeypatch):
    """Each tool times by CUDA events: --cpu raises, never times the CPU,
    and without a card its main() raises before any work."""
    args = tool.build_argparser().parse_args(["--cpu"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tool.run(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([])


def test_profile_cuts_profiles_a_lost_row_again_and_marks_it(monkeypatch):
    """timing.profile_cuts with the card's timers faked: a row whose records
    are whole on the second profile keeps its numbers; a row lost twice
    reads busy None, and so do its and the next row's differences."""
    from gslivm_tpu_torch.tools import timing

    reads = {"a": [True], "b": [False, True], "c": [False, False], "d": [True]}
    calls = []

    def fake_busy(fn, *args, device="cuda"):
        name = fn()
        calls.append(name)
        whole = reads[name].pop(0)
        return {"device_busy_ms": 1.0 if whole else 0.25, "kernels_per_call": 4.0 if whole else 1.0,
                "kernel_busy_ms": {"K1": 0.5, "K2": 0.0, "K3": 0.0}, "records_whole": whole}

    monkeypatch.setattr(timing, "device_busy_ms", fake_busy)
    monkeypatch.setattr(timing, "report", lambda name, fn, *a, **kw: 2.0)
    cuts = [(n, lambda n=n: n, ()) for n in "abcd"]
    rows = timing.profile_cuts(cuts, log=lambda *_: None)
    assert calls == ["a", "b", "b", "c", "c", "d"]
    assert [r["lost"] for r in rows] == [False, False, True, False]
    assert rows[1]["busy_ms"] == 1.0 and rows[1]["other_ms"] == 0.5 and rows[1]["d_busy_ms"] == 0.0
    assert rows[2]["busy_ms"] is None and rows[2]["K1"] is None and rows[2]["d_busy_ms"] is None
    assert rows[2]["kernels"] == 1.0 and rows[2]["d_ms"] == 0.0
    assert rows[3]["busy_ms"] == 1.0 and rows[3]["d_busy_ms"] is None
