"""Port parity of the band pieces of the sharded step: band binning (bit-
equal to the JAX package's), tile bands that compose to the full image
(colour, depth, alpha and the differentiable transmittance, with their
gradients through the plain K1/K2), and the three band sums
(ssim_band_sum, l1_band_sum, delta_depth_band_sum) against JAX's, which
partition the full losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models import training as jtr
from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import binning as jbin
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu.ops import rasterize_reference as jref
from gslivm_tpu_torch.models import training as ttr
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops import binning as tbin
from gslivm_tpu_torch.ops import losses as tlosses
from gslivm_tpu_torch.ops import rasterize_reference as tref
from gslivm_tpu_torch.ops import rasterize_tiles as ttiles

torch.set_num_threads(1)


def _scene(rng, n, spread=1.0, z0=5.0, scale_hi=0.15):
    means = (rng.normal(0, spread, (n, 3)) + [0, 0, z0]).astype(np.float32)
    scales = rng.uniform(0.02, scale_hi, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3)).astype(np.float32)
    return means, scales, quats, opac, shs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


@pytest.mark.parametrize("block", [(1, 1), (2, 2)])
def test_band_binning_bit_equal(block):
    """Both binners get JAX's preprocessed gaussians; every integer output
    of every band is equal, for bands inside, at the edge of and past the
    image, with the tile cull and with tight budgets."""
    rng = np.random.default_rng(2)
    jc = jmake_camera(np.eye(3), np.zeros(3), 64, 48, fovx=1.0, fovy=0.8)
    jp = jref.preprocess(*(jnp.asarray(a) for a in _scene(rng, 200, spread=1.2,
                                                           scale_hi=0.25)), jc)
    tp = tref.PreprocessedGaussians(*(torch.from_numpy(np.array(x)) for x in jp))
    sgrid_y = -(-3 // block[1])
    bands = [(0, 1), (1, 1), (sgrid_y - 1, 2), (sgrid_y, 1), (0, sgrid_y)]
    for (start, rows), (max_instances, max_chunks, slack) in zip(
            bands, ((4096, 64, 1.0), (4096, 64, 1.0), (256, 1, 0.1), (4096, 64, 1.0),
                    (128, 1, 0.1))):
        kw = dict(max_instances=max_instances, max_chunks_per_tile=max_chunks,
                  capacity_slack=slack, block_x=block[0], block_y=block[1],
                  band_start=start, band_rows=rows)
        jb = jax.jit(jbin.bin_instances, static_argnums=(1, 2), static_argnames=(
            *kw, "aligned_layout"))(jp, 64, 48, aligned_layout=False, **kw)
        tb = tbin.bin_instances(tp, 64, 48, **kw)
        for f in tbin.BinnedInstances._fields:
            np.testing.assert_array_equal(_np(getattr(tb, f)), np.asarray(getattr(jb, f)),
                                          err_msg=f"{f} {kw}")
        if start >= sgrid_y:
            assert int(tb.num_instances) == 0
    with pytest.raises(ValueError):
        tbin.bin_instances(tp, 64, 48, 4096, band_start=0)


@pytest.mark.parametrize("block", [(1, 1), (2, 1)])
def test_tile_bands_compose_to_full_image(block):
    """Banded renders stitch to the full frame (the pixel-sharding unit):
    static tile_band embeds, band_rows/band_start returns the band; rows
    0-5 of render_tiles_raw, T included, carry the same gradients as the
    full render's."""
    rng = np.random.default_rng(5)
    w, h = 64, 64
    cam = tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")
    args = [torch.from_numpy(a).requires_grad_(True) for a in _scene(rng, 120)]
    bg = torch.tensor([0.1, 0.2, 0.3])
    kw = dict(bg_color=bg, max_instances=1 << 14, block_x=block[0], block_y=block[1])
    full = ttiles.rasterize_tiles(*args, cam, **kw)
    sgrid_y = -(-4 // block[1])
    stitched = torch.zeros_like(full.color)
    for y0 in range(0, sgrid_y, 2):
        band = ttiles.rasterize_tiles(*args, cam, tile_band=(y0, min(y0 + 2, sgrid_y)), **kw)
        rows = slice(y0 * 16 * block[1], (y0 + 2) * 16 * block[1])
        stitched[:, rows] = band.color[:, rows]
        outside = torch.ones(h, dtype=torch.bool)
        outside[rows] = False
        torch.testing.assert_close(band.color[:, outside],
                                   bg[:, None, None].expand(3, int(outside.sum()), w),
                                   rtol=0, atol=0)
        dyn = ttiles.rasterize_tiles(*args, cam, band_rows=2, band_start=y0, **kw)
        n = min(h, (y0 + 2) * 16 * block[1]) - y0 * 16 * block[1]
        torch.testing.assert_close(dyn.color[:, :n], band.color[:, rows], rtol=0, atol=0)
    np.testing.assert_allclose(_np(stitched), _np(full.color), atol=1e-6, rtol=1e-5)

    # the raw rows, T included, through K1 and K2's plain versions
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, (6, sgrid_y * 16 * block[1], w))
                               .astype(np.float32))
    pre = tref.preprocess(*args, cam)
    raw_kw = dict(max_instances=1 << 14, block_x=block[0], block_y=block[1])
    img, _, _ = ttiles.render_tiles_raw(pre, w, h, **raw_kw)
    g_full = torch.autograd.grad((img[:6] * weights).sum(), args, retain_graph=True)
    bands = []
    for y0 in range(sgrid_y):
        b, _, cfg = ttiles.render_tiles_raw(pre, w, h, band_rows=1, band_start=y0, **raw_kw)
        assert cfg.grid_y == 1
        bands.append(b[:6])
    img_b = torch.cat(bands, dim=1)
    np.testing.assert_allclose(_np(img_b), _np(img[:6]), atol=1e-6, rtol=1e-5)
    g_band = torch.autograd.grad((img_b * weights).sum(), args)
    for name, a, b in zip(("means", "scales", "quats", "opac", "shs"), g_full, g_band):
        assert _scaled_err(_np(a), _np(b)) <= 1e-5, name


@pytest.mark.parametrize("g", [2, 4])
def test_split_depth_slabs_packs_as_the_exchange(g):
    """The exchange's packing run for g ranks in one process: slab k holds
    the gaussians of global depth ranks [k*S, (k+1)*S) at their offsets;
    with one column a box, the gaussians past it are dropped and counted."""
    from gslivm_tpu_torch.parallel import primitive

    rng = np.random.default_rng(11)
    cam = tmake_camera(np.eye(3), np.zeros(3), 64, 48, fovx=1.0, fovy=0.8, device="cpu")
    pre = tref.preprocess(*(torch.from_numpy(a) for a in _scene(rng, 96)), cam)
    S = 96 // g
    rows = primitive._pre_to_rows(pre)
    order = torch.argsort(primitive._depth_keys(pre), stable=True)
    slabs, overflow = primitive.split_depth_slabs(pre, g)
    assert int(overflow) == 0
    for k, slab in enumerate(slabs):
        torch.testing.assert_close(primitive._pre_to_rows(slab),
                                   rows[:, order[k * S:(k + 1) * S]], rtol=0, atol=0)
    # one column a box: each rank keeps its first gaussian for each slab
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(96)
    want, dropped = torch.zeros((g, primitive.N_ROWS, S)), 0
    for k in range(g):
        seen = set()
        for i in range(k * S, (k + 1) * S):
            dest, pos = divmod(int(rank_of[i]), S)
            if dest in seen:
                dropped += 1
            else:
                seen.add(dest)
                want[dest, :, pos] = rows[:, i]
    slabs, overflow = primitive.split_depth_slabs(pre, g, budget_per_pair=1)
    assert int(overflow) == dropped > 0
    for k, slab in enumerate(slabs):
        torch.testing.assert_close(primitive._pre_to_rows(slab), want[k], rtol=0, atol=0)


@pytest.mark.parametrize("g", [2, 4])
def test_fold_of_slabs_is_within_the_stop_bound(g):
    """On a scene dense enough that many pixels stop early, the folded
    slabs differ from the one-pass render (plain K1) by more than rounding,
    and by no more than fold_stop_bound times the largest splat colour
    (depth for D, 1 for A and T) plus rounding."""
    from gslivm_tpu_torch.parallel import primitive

    rng = np.random.default_rng(12)
    w, h = 64, 48
    cam = tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")
    means, scales, quats, _, shs = _scene(rng, 1200, spread=0.6, scale_hi=0.3)
    opac = rng.uniform(0.6, 0.99, (1200,)).astype(np.float32)
    pre = tref.preprocess(*(torch.from_numpy(a) for a in (means, scales, quats, opac, shs)),
                          cam)
    kw = dict(max_instances=1 << 16, block_x=2, block_y=2)
    one, _, cfg = ttiles.render_tiles_raw(pre, w, h, **kw)
    slabs, overflow = primitive.split_depth_slabs(pre, g)
    assert int(overflow) == 0
    parts = torch.stack([primitive.render_slab_band(s, w, h, cfg.grid_y, 0, max_instances=1 << 16,
                                                    block=(2, 2))[0] for s in slabs])
    folded = primitive.fold_partials(parts)
    bound = primitive.fold_stop_bound(parts, one[5])
    assert float((bound > 0).float().mean()) > 0.2  # a walk stopped at many pixels
    cmax = (float(pre.color[pre.valid].max()), float(pre.depth[pre.valid].max()), 1.0, 1.0)
    worst = 0.0
    for name, r, c in (("C", slice(0, 3), cmax[0]), ("D", 3, cmax[1]), ("A", 4, 1.0),
                       ("T", 5, 1.0)):
        d = (folded[r] - one[r]).abs()
        allowed = bound * c + 1e-6 * max(float(one[r].abs().max()), 1.0)
        assert bool((d <= allowed).all()), (name, float((d - allowed).max()))
        worst = max(worst, float(d.max()) / max(float(one[r].abs().max()), 1.0))
    assert worst > 1e-5  # the stop differs: the bound is not vacuous here


def _pair(rng, h, w):
    img = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    return img, gt


def test_image_band_sums_match_jax_and_partition():
    """ssim_band_sum and l1_band_sum equal JAX's for every band (a partial
    last band and one past the image included); summed over bands they are
    the full losses times C*H*W, gradients included."""
    rng = np.random.default_rng(7)
    h, w = 37, 29
    img, gt = _pair(rng, h, w)
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(gt)
    n_rows = 10
    for fn in ("ssim_band_sum", "l1_band_sum"):
        jfn = jax.jit(getattr(jlosses, fn), static_argnums=3)
        tfn = getattr(tlosses, fn)
        total = 0.0
        for lo in range(0, h + n_rows, n_rows):
            jv = float(jfn(jnp.asarray(img), jnp.asarray(gt), lo, n_rows))
            tv = tfn(ti, tg, lo, n_rows)
            assert float(tv.detach()) == pytest.approx(jv, rel=1e-5, abs=1e-5), (fn, lo)
            total = total + tv
        full = (tlosses.ssim if fn == "ssim_band_sum" else tlosses.l1_loss)(ti, tg)
        assert float(total.detach()) == pytest.approx(float(full.detach()) * 3 * h * w, rel=1e-5)
        (g_band,) = torch.autograd.grad(total, ti)
        (g_full,) = torch.autograd.grad(full * 3 * h * w, ti)
        assert _scaled_err(_np(g_full), _np(g_band)) <= 1e-5, fn
        jg = jax.jit(jax.grad(lambda x: sum(jfn(x, jnp.asarray(gt), lo, n_rows)
                                            for lo in range(0, h, n_rows))))(jnp.asarray(img))
        assert _scaled_err(np.asarray(jg), _np(g_band)) <= 1e-5, fn


def test_delta_depth_band_sum_matches_jax_and_partitions():
    rng = np.random.default_rng(2)
    h, w = 29, 40
    centers = ([0, 0, 0], [0.06, 0.02, 0.0])
    jc = [jmake_camera(np.eye(3), np.asarray(c), w, h, fovx=1.0, fovy=0.8) for c in centers]
    tc = [tmake_camera(np.eye(3), np.asarray(c), w, h, fovx=1.0, fovy=0.8, device="cpu")
          for c in centers]
    depth = rng.uniform(2.0, 8.0, (2, h, w)).astype(np.float32)
    depth[0, :5, :7] = 0.0  # background: the warp makes inf/NaN coordinates
    acc = rng.uniform(0.0, 1.0, (2, h, w)).astype(np.float32)
    td = torch.from_numpy(depth[0]).requires_grad_(True)
    targs = (td, torch.from_numpy(acc[0]), tc[0],
             torch.from_numpy(depth[1]), torch.from_numpy(acc[1]), tc[1])
    jargs = (jnp.asarray(depth[0]), jnp.asarray(acc[0]), jc[0],
             jnp.asarray(depth[1]), jnp.asarray(acc[1]), jc[1])
    total = 0.0
    for lo in range(0, h + 8, 8):
        tv = ttr.delta_depth_band_sum(*targs, lo, 8)
        jv = float(jtr.delta_depth_band_sum(*jargs, lo, 8))
        # the tolerance of the whole-image loss (test_torch_training.py)
        assert float(tv.detach()) == pytest.approx(jv, rel=1e-4, abs=1e-6), lo
        total = total + tv
    full = ttr.delta_depth_loss(*targs)
    assert float(total.detach()) > 0
    assert float(total.detach()) == pytest.approx(float(full.detach()) * h * w, rel=1e-5)
    (g_band,) = torch.autograd.grad(total, td)
    (g_full,) = torch.autograd.grad(full * h * w, td)
    # the zero-depth pixels' gradient is NaN in both (the warp divides by
    # their reprojected depth): the same pixels, and equal elsewhere
    g_band, g_full = _np(g_band), _np(g_full)
    ok = np.isfinite(g_full)
    np.testing.assert_array_equal(np.isfinite(g_band), ok)
    assert ok.mean() > 0.9
    assert _scaled_err(g_full[ok], g_band[ok]) <= 1e-5
