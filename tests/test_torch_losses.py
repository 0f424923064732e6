"""Port parity of the photometric losses and K3's plain version: the
shift-add blur and blur_many's VJP, SSIM (with and without ref_stats), PSNR,
L1, the window quirk, inv_depth and the offline metrics harness (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.ops import losses as jloss
from gslivm_tpu.utils import metrics as jmetrics
from gslivm_tpu_torch.ops import blur as tblur
from gslivm_tpu_torch.ops import losses as tloss
from gslivm_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(seed, c=3, h=40, w=56, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("window", [11, 7])
def test_gaussian_1d_identical(window, symmetric):
    np.testing.assert_array_equal(tloss.gaussian_1d(window, 1.5, symmetric),
                                  jloss.gaussian_1d(window, 1.5, symmetric))


def test_plain_blur_matches_jax_shift_add():
    """Same taps, same summation order: equal up to XLA's fusion choices."""
    a, _ = _pair(0)
    taps = jloss.gaussian_1d()
    jout = jloss._gaussian_blur_shift_add(jnp.asarray(a), taps)
    tout = tloss._gaussian_blur_shift_add(torch.from_numpy(a), taps)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0, atol=1e-6)
    # blur_many on CPU tensors is the same plain blur
    np.testing.assert_array_equal(_np(tblur.blur_many(torch.from_numpy(a), taps)),
                                  _np(tout))


def test_blur_many_vjp_matches_jax():
    """The VJP is the blur with reversed taps (asymmetric window: the
    orientation is pinned by comparing against jax.vjp of the shift-add)."""
    a, g = _pair(1)
    taps = jloss.gaussian_1d()
    _, vjp = jax.vjp(lambda x: jloss._gaussian_blur_shift_add(x, taps), jnp.asarray(a))
    (jg,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(a).requires_grad_(True)
    out = tblur.blur_many(x, taps)
    (tg,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=0, atol=1e-6)
    assert tblur.blur_cuda.launches == 0  # CPU tensors never launch K3
    with pytest.raises(ValueError, match="CUDA tensor"):
        tblur.blur_cuda(torch.from_numpy(a), taps)


@pytest.mark.parametrize("seed,noise", [(2, 0.02), (3, 0.3)])
def test_ssim_psnr_l1_match_jax(seed, noise):
    a, b = _pair(seed, noise=noise)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    # scalar means of f32 maps: 1e-6 absolute on SSIM in [0, 1]
    np.testing.assert_allclose(float(tloss.ssim(ta, tb)), float(jloss.ssim(ja, jb)),
                               rtol=0, atol=1e-6)
    stats = tloss.ssim_ref_stats(tb)
    jstats = jloss.ssim_ref_stats(jb)
    for s, js in zip(stats, jstats):
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=0, atol=1e-6)
    # ref_stats reuses exactly the same blurs: bit-identical to the full path
    assert float(tloss.ssim(ta, tb, ref_stats=stats)) == float(tloss.ssim(ta, tb))
    np.testing.assert_allclose(float(tloss.psnr(ta, tb)), float(jloss.psnr(ja, jb)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tloss.l1_loss(ta, tb)),
                               float(jloss.l1_loss(ja, jb)), rtol=1e-6)
    np.testing.assert_allclose(float(tloss.image_loss(ta, tb)),
                               float(jloss.image_loss(ja, jb)), rtol=0, atol=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = _pair(4, h=24, w=32)
    (jg,) = jax.grad(lambda x: jloss.ssim(x, jnp.asarray(b)), argnums=(0,))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    tloss.ssim(x, torch.from_numpy(b)).backward()
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jg), rtol=0, atol=1e-4 * scale)


def test_inv_depth_matches_jax():
    d = np.asarray([[0.0, 0.005, 0.01, 0.5, 3.0]], np.float32)
    np.testing.assert_array_equal(_np(tloss.inv_depth(torch.from_numpy(d))),
                                  np.asarray(jloss.inv_depth(jnp.asarray(d))))


def test_image_pair_metrics_match_jax():
    rng = np.random.default_rng(5)
    render = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    gt = np.clip(render.astype(int) + rng.integers(-20, 20, render.shape),
                 0, 255).astype(np.uint8)
    jm = jmetrics.image_pair_metrics(render, gt)
    tm = tmetrics.image_pair_metrics(render, gt, device="cpu")
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # a CPU tensor keeps its device; numpy input without device= needs CUDA
    chw = torch.from_numpy(render.transpose(2, 0, 1).astype(np.float32) / 255.0)
    tm2 = tmetrics.image_pair_metrics(chw, gt)
    np.testing.assert_allclose(tm2["psnr"], tm["psnr"], rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmetrics.image_pair_metrics(render, gt)
    da = rng.uniform(0, 5, (16, 16)).astype(np.float32)
    db = rng.uniform(0, 5, (16, 16)).astype(np.float32)
    np.testing.assert_allclose(tmetrics.inverse_depth_l1(da, db, device="cpu"),
                               jmetrics.inverse_depth_l1(da, db), rtol=1e-6)


def test_evaluate_dirs_match_jax(tmp_path):
    from gslivm_tpu.utils.outputs import save_png

    rng = np.random.default_rng(6)
    (tmp_path / "sbs").mkdir()
    (tmp_path / "r").mkdir()
    (tmp_path / "g").mkdir()
    for i in range(2):
        r = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        g = np.clip(r.astype(int) + rng.integers(-30, 30, r.shape), 0, 255).astype(np.uint8)
        save_png(str(tmp_path / "sbs" / f"{i}.png"), np.concatenate([r, g], axis=1))
        save_png(str(tmp_path / "r" / f"{i}.png"), r)
        save_png(str(tmp_path / "g" / f"{i}.png"), g)
        np.testing.assert_array_equal(tmetrics.load_png(str(tmp_path / "r" / f"{i}.png")), r)
    for jres, tres in (
            (jmetrics.evaluate_dir(str(tmp_path / "sbs")),
             tmetrics.evaluate_dir(str(tmp_path / "sbs"), device="cpu")),
            (jmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "g")),
             tmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "g"),
                                    device="cpu"))):
        assert tres["count"] == jres["count"] == 2
        # f32 means over ~2300 terms, summed in another order than XLA's
        for k in ("mean_psnr", "mean_ssim", "mean_l1"):
            np.testing.assert_allclose(tres[k], jres[k], rtol=5e-5, err_msg=k)
        # lpips is optional in both: null when the package is absent
        assert (tres["mean_lpips"] is None) == (jres["mean_lpips"] is None)
