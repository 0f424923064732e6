"""Port parity of the rasterizer: the naive oracle (forward + all five
parameter gradients under the depth-grad-drop contract), bin_instances
(integer outputs bit-equal) and the tile renderer (K1's plain version)
against the JAX package's Pallas path in interpret mode (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import binning as jbin
from gslivm_tpu.ops import rasterize as jras
from gslivm_tpu.ops import rasterize_reference as jref
from gslivm_tpu.ops import rasterize_pallas as jrp
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops import binning as tbin
from gslivm_tpu_torch.ops import rasterize as tras
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


def _cams(w, h):
    return (jmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8),
            tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8,
                         device="cpu"))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


def test_naive_forward_and_grads_match_jax():
    rng = np.random.default_rng(0)
    w, h = 48, 32
    scene = _scene(rng, 80)
    jc, tc = _cams(w, h)
    wc = rng.uniform(0.5, 1.5, (3, h, w)).astype(np.float32)
    wa = rng.uniform(0.5, 1.5, (h, w)).astype(np.float32)
    wd = rng.uniform(0.5, 1.5, (h, w)).astype(np.float32)

    def jloss(*a):
        out = jras.rasterize(*a, jc, settings=jras.RasterizeSettings(backend="naive"))
        # the depth term's gradient is dropped by the contract
        return (jnp.sum(out.color * wc) + jnp.sum(out.acc * wa)
                + jnp.sum(out.depth * wd)), out

    (jv, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(*(jnp.asarray(a) for a in scene))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in scene]
    tout = tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(backend="naive"))
    tv = ((tout.color * torch.from_numpy(wc)).sum() + (tout.acc * torch.from_numpy(wa)).sum()
          + (tout.depth * torch.from_numpy(wd)).sum())
    tv.backward()

    # forward: f32 sums of up to 80 terms in another order
    for f in ("color", "depth", "acc", "final_T"):
        assert _scaled_err(getattr(jout, f), _np(getattr(tout, f))) <= 1e-5, f
    np.testing.assert_array_equal(_np(tout.n_contrib), np.asarray(jout.n_contrib))
    np.testing.assert_array_equal(_np(tout.radii), np.asarray(jout.radii))
    assert int(tout.num_instances) == int(jout.num_instances)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    # gradients: autograd of the same math in both; 1e-4 of the largest
    # component covers the re-associated cumprod/sum backward passes
    for name, jgrad, t in zip(("means", "scales", "quats", "opac", "shs"), jg, targs):
        assert _scaled_err(jgrad, _np(t.grad)) <= 1e-4, name


def test_depth_grad_drop_contract():
    rng = np.random.default_rng(1)
    _, tc = _cams(32, 32)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in _scene(rng, 30)]
    out = tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(backend="naive"))
    (g,) = torch.autograd.grad(out.depth.sum(), targs[0])
    assert float(g.abs().max()) == 0.0
    out = tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(
        backend="naive", depth_grad=True))
    (g,) = torch.autograd.grad(out.depth.sum(), targs[0])
    assert float(g.abs().max()) > 0.0


def _jpre_to_torch(jp):
    return tref.PreprocessedGaussians(*(torch.from_numpy(np.array(x)) for x in jp))


@pytest.mark.parametrize("block", [(1, 1), (2, 2)])
@pytest.mark.parametrize("tile_cull", [True, False])
def test_bin_instances_bit_equal(block, tile_cull):
    """Both binners get the SAME preprocessed gaussians (JAX's), so any
    difference is the binning itself; every integer output must be equal.
    The budgets are tight enough that the cap, the capacity clip and the
    max_instances cut all bite, so overflow and the sentinel slots are
    exercised."""
    rng = np.random.default_rng(2)
    jc, _ = _cams(64, 48)
    scene = _scene(rng, 200, spread=1.2, scale_hi=0.25)
    jp = jref.preprocess(*(jnp.asarray(a) for a in scene), jc)
    tp = _jpre_to_torch(jp)
    for max_instances, max_chunks, slack in ((4096, 64, 1.0), (256, 1, 0.1)):
        kw = dict(max_instances=max_instances, max_chunks_per_tile=max_chunks,
                  tile_cull=tile_cull, capacity_slack=slack,
                  block_x=block[0], block_y=block[1])
        jb = jbin.bin_instances(jp, 64, 48, aligned_layout=False, **kw)
        tb = tbin.bin_instances(tp, 64, 48, **kw)
        for f in tbin.BinnedInstances._fields:
            np.testing.assert_array_equal(_np(getattr(tb, f)),
                                          np.asarray(getattr(jb, f)),
                                          err_msg=f"{f} {kw}")
        if max_instances == 256:
            assert int(tb.overflow) > 0


def test_padded_capacity_matches():
    for args in ((4096, 12, 1.0), (1 << 20, 2040, 0.35), (600, 6, 0.1)):
        assert tbin._padded_capacity(*args) == jbin._padded_capacity(*args)


def test_rasterize_tiles_matches_pallas_interpret():
    """K1's plain version through the whole tiles path against the JAX
    Pallas kernel in interpret mode: 64x48, 200 gaussians, block 2x2."""
    rng = np.random.default_rng(3)
    w, h = 64, 48
    scene = _scene(rng, 200)
    jc, tc = _cams(w, h)
    bg = np.asarray([0.1, 0.6, 0.9], np.float32)
    kw = dict(max_instances=1 << 13, capacity_slack=0.35, block_x=2, block_y=2,
              max_chunks_per_tile=64)
    jout = jrp.rasterize_pallas(*(jnp.asarray(a) for a in scene), jc,
                            bg_color=jnp.asarray(bg), interpret=True, **kw)
    tout = ttiles.rasterize_tiles(*(torch.from_numpy(a) for a in scene), tc,
                                  bg_color=torch.from_numpy(bg), **kw)
    # rows 0-5 (color carries C + T*bg): f32 sums over a chunk in another
    # order than XLA's reduction, 1e-5 of the image scale
    for f in ("color", "depth", "acc", "final_T"):
        assert _scaled_err(getattr(jout, f), _np(getattr(tout, f))) <= 1e-5, f
    # rows 6-7 and the counters are integers: equal
    np.testing.assert_array_equal(_np(tout.n_contrib), np.asarray(jout.n_contrib))
    for f in ("overflow", "num_instances", "max_nchunks", "walked_chunks"):
        assert int(getattr(tout, f)) == int(getattr(jout, f)), f
    assert int(tout.overflow) == 0 and int(tout.walked_chunks) > 0

    # the neff row itself (per tile), through the shared lower-level entry
    jpre = jref.preprocess(*(jnp.asarray(a) for a in scene), jc)
    jband, _, _ = jrp.render_tiles_raw(jpre, w, h, interpret=True, **kw)
    tband, _, _ = ttiles.render_tiles_raw(
        tref.preprocess(*(torch.from_numpy(a) for a in scene), tc), w, h, **kw)
    np.testing.assert_array_equal(_np(tband[7]), np.asarray(jband[7]))
    np.testing.assert_array_equal(_np(tband[6]), np.asarray(jband[6]))


@pytest.mark.parametrize("contrib_stats", [True, False])
def test_plain_compositor_matches_pallas_kernel_vote(contrib_stats):
    """K1's plain version against the JAX forward kernel itself (interpret
    mode) on crafted runs: tile 0 saturates inside its first chunk, so the
    all-done vote must stop it at neff 1 of 3 chunks; tile 1's run starts
    off a 128 boundary and never saturates (neff = its 2 chunks)."""
    rng = np.random.default_rng(7)
    cnt = np.asarray([300, 200], np.int32)
    start = np.asarray([0, 300], np.int32)
    nch = (cnt + 127) // 128
    L = int(cnt.sum())
    inst = np.zeros((L, ttiles.FEAT), np.float32)
    inst[:, ttiles._FX] = rng.uniform(0, 32, L)
    inst[:, ttiles._FY] = rng.uniform(0, 16, L)
    inst[:, ttiles._FA] = rng.uniform(0.001, 0.05, L)
    inst[:, ttiles._FB] = rng.uniform(-0.001, 0.001, L)
    inst[:, ttiles._FC] = rng.uniform(0.001, 0.05, L)
    inst[:, ttiles._FO] = np.where(np.arange(L) < 300, 0.95, rng.uniform(0.0, 0.02, L))
    inst[:, ttiles._FR:ttiles._FD + 1] = rng.uniform(0, 2, (L, 4))
    cfg = ttiles.TileConfig(grid_x=2, grid_y=1, contrib_stats=contrib_stats)
    tout = ttiles.composite_tiles_plain(
        torch.from_numpy(inst), torch.from_numpy(start), torch.from_numpy(nch),
        torch.from_numpy(cnt), cfg)
    jcfg = jrp.PallasConfig(grid_x=2, grid_y=1, max_chunks_per_tile=8,
                            interpret=True, skip_contrib=not contrib_stats)
    jinst = np.concatenate([inst.T, np.zeros((ttiles.FEAT, 256), np.float32)], 1)
    jout = np.asarray(jrp._fwd_call(jcfg, jnp.asarray(jinst), jnp.asarray(start),
                                    jnp.asarray(nch), jnp.asarray(cnt), save_ckpt=False))
    tout = _np(tout)
    np.testing.assert_array_equal(tout[:, 7, 0], [1, 2])  # the vote stopped tile 0
    np.testing.assert_array_equal(tout[:, 6:], jout[:, 6:])
    # rows 0-5: f32 chunk sums in another order than XLA's
    assert _scaled_err(jout[:, :6], tout[:, :6]) <= 1e-5


def test_tiles_backend_is_forward_only_and_auto_is_naive_on_cpu():
    """The tiles backend (once forward only) now gives gradients through
    the plain K1/K2 on the CPU, equal to the naive backend's within f32
    re-association; "auto" is naive on the CPU and tiles on the card."""
    rng = np.random.default_rng(4)
    _, tc = _cams(32, 32)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in _scene(rng, 20)]
    tiles = tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(backend="tiles"))
    assert tiles.color.requires_grad and not tiles.final_T.requires_grad
    g_tiles = torch.autograd.grad(tiles.color.sum() + tiles.acc.sum(), targs)
    auto = tras.rasterize(*targs, tc)
    naive = tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(backend="naive"))
    assert auto.color.requires_grad
    np.testing.assert_array_equal(_np(auto.color), _np(naive.color))
    assert _scaled_err(_np(naive.color), _np(tiles.color)) <= 1e-5
    g_naive = torch.autograd.grad(naive.color.sum() + naive.acc.sum(), targs)
    for a, b in zip(g_naive, g_tiles):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())
    assert tras._resolve_backend("auto", torch.device("cuda")) == "tiles"
    assert tras._resolve_backend("auto", torch.device("cpu")) == "naive"
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        tras.rasterize(*targs, tc, settings=tras.RasterizeSettings(backend="pallas"))


def test_composite_tiles_cpu_takes_plain_version(monkeypatch):
    rng = np.random.default_rng(5)
    _, tc = _cams(64, 48)
    pre = tref.preprocess(*(torch.from_numpy(a) for a in _scene(rng, 100)), tc)
    inst, binned, cfg = ttiles.prepare_tiles(pre, 64, 48, max_instances=4096,
                                             block_x=2, block_y=2)
    before = ttiles.composite_tiles.launches
    args = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
    out = ttiles.composite_tiles(*args)
    assert ttiles.composite_tiles.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(_np(out), _np(ttiles.composite_tiles_plain(*args)))
    # stepping one tile at a time (as at full size, many groups) changes nothing
    monkeypatch.setattr(ttiles, "_PLAIN_GROUP_ELEMENTS", 1)
    np.testing.assert_array_equal(_np(out), _np(ttiles.composite_tiles_plain(*args)))
    # a zero-chunk tile renders background with neff 0
    empty = binned.tile_nchunks == 0
    if bool(empty.any()):
        t = int(torch.nonzero(empty)[0])
        assert float(out[t, 5].min()) == 1.0 and float(out[t, 7].max()) == 0.0


def test_mark_visible_parity():
    rng = np.random.default_rng(6)
    jc, tc = _cams(32, 32)
    means = (rng.normal(0, 1, (50, 3)) + [0, 0, 0.5]).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tras.mark_visible(torch.from_numpy(means), tc)),
        np.asarray(jras.mark_visible(jnp.asarray(means), jc)))


def test_naive_prefix_composite_equals_full_composite():
    """The naive oracle composites only the valid prefix of its depth order
    (preprocess's culled gaussians sort last and add nothing to a pixel).
    On a scene where over half the gaussians are culled (behind the camera,
    far outside the view, or inactive) it gives what compositing every
    gaussian gives: images and all five parameter gradients within 1e-6 of
    scale (f32 sums over a shorter gaussian axis may round apart)."""
    rng = np.random.default_rng(7)
    w, h = 40, 32
    means, scales, quats, opac, shs = _scene(rng, 600)
    means[:150, 2] = -means[:150, 2]        # behind the camera
    means[150:300, 0] += 40.0                # far outside the view
    active = torch.from_numpy(rng.uniform(size=600) < 0.8)
    _, cam = _cams(w, h)
    bg = torch.tensor([0.2, 0.5, 0.8])
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (means, scales, quats, opac, shs)]

    def full(*xs):
        pre = tref.preprocess(*xs, cam, active_mask=active)
        order = tref.depth_order(pre)
        pre_sorted = tref.PreprocessedGaussians(*(x[order] for x in pre))
        ys, xs_ = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        pix = torch.stack([xs_.reshape(-1), ys.reshape(-1)], dim=-1).float()
        tile = torch.div(pix, tref.TILE, rounding_mode="floor").to(torch.int32)
        c, d, a, t, n = tref._composite_pixels(pix, tile, pre_sorted, bg)
        return (c.reshape(h, w, 3).permute(2, 0, 1), d.reshape(h, w), a.reshape(h, w),
                t.reshape(h, w), n.reshape(h, w)), pre

    (fc, fd, fa, ft, fn), pre = full(*leaves)
    assert int(pre.valid.sum()) < 300  # most of the scene is culled
    out = tref.rasterize_naive(*leaves, cam, bg_color=bg, active_mask=active)
    for a, b in ((out.color, fc), (out.depth, fd), (out.acc, fa), (out.final_T, ft)):
        assert _scaled_err(_np(b), _np(a)) <= 1e-6
    assert torch.equal(out.n_contrib, fn)

    def loss(c, d, a):
        return (c * c).sum() + 0.3 * d.sum() + 0.1 * a.sum()

    g_prefix = torch.autograd.grad(loss(out.color, out.depth, out.acc), leaves)
    g_full = torch.autograd.grad(loss(fc, fd, fa), leaves)
    for a, b in zip(g_prefix, g_full):
        assert _scaled_err(_np(b), _np(a)) <= 1e-6
