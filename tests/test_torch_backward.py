"""Port parity of the tile backward: K1's plain checkpoint output and K2's
plain version against the JAX Pallas kernels in interpret mode (CPU), the
tiles backend's five parameter gradients against the JAX tile and naive
renderers, and the depth-skipping backward against the full one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import rasterize_pallas as jrp
from gslivm_tpu.ops import rasterize_reference as jref
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops import rasterize_tiles as ttiles

torch.set_num_threads(1)

CHUNK = 128


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _crafted_runs(rng):
    """Two 16x16 tiles: tile 0's 300 near-opaque instances saturate every
    pixel inside chunk 0 (neff 1 of 3), tile 1's 200 faint ones start off a
    128 boundary and never saturate (neff 2 of 2)."""
    cnt = np.asarray([300, 200], np.int32)
    start = np.asarray([0, 300], np.int32)
    L = int(cnt.sum())
    inst = np.zeros((L, ttiles.FEAT), np.float32)
    inst[:, ttiles._FX] = rng.uniform(0, 32, L)
    inst[:, ttiles._FY] = rng.uniform(0, 16, L)
    inst[:, ttiles._FA] = rng.uniform(0.001, 0.05, L)
    inst[:, ttiles._FB] = rng.uniform(-0.001, 0.001, L)
    inst[:, ttiles._FC] = rng.uniform(0.001, 0.05, L)
    inst[:, ttiles._FO] = np.where(np.arange(L) < 300, 0.95, rng.uniform(0.0, 0.3, L))
    inst[:, ttiles._FR:ttiles._FD + 1] = rng.uniform(0, 2, (L, 4))
    inst[:, ttiles._FID] = rng.permutation(L)  # rank ids ride along
    return inst, start, cnt, (cnt + CHUNK - 1) // CHUNK


@pytest.mark.parametrize("depth_grad", [True, False])
def test_plain_checkpoints_and_backward_match_pallas_kernels(depth_grad):
    """K1's plain checkpoint rows and K2's plain rows against _fwd_call(
    save_ckpt=True) and _bwd_call, interpret mode. JAX writes instance
    (tile t, chunk i, lane j) at column poff[t] + 128 i + j of its
    CHUNK-aligned [16, pad] layout; the port at row start[t] + 128 i + j."""
    rng = np.random.default_rng(7)
    inst, start, cnt, nch = _crafted_runs(rng)
    cfg = ttiles.TileConfig(grid_x=2, grid_y=1, contrib_stats=False, max_chunks=8)
    targs = (torch.from_numpy(inst), torch.from_numpy(start),
             torch.from_numpy(nch), torch.from_numpy(cnt))
    tout, tckpt = ttiles.composite_tiles_plain(*targs, cfg, save_ckpt=True)

    poff = np.asarray([0, 3 * CHUNK], np.int32)
    jcfg = jrp.PallasConfig(grid_x=2, grid_y=1, max_chunks_per_tile=8,
                            interpret=True, skip_contrib=True, pad_cols=5 * CHUNK,
                            skip_depth_grad=not depth_grad)
    jinst = jnp.asarray(np.concatenate([inst.T, np.zeros((ttiles.FEAT, 2 * CHUNK),
                                                         np.float32)], 1))
    jout, jckpt = jrp._fwd_call(jcfg, jinst, jnp.asarray(start), jnp.asarray(nch),
                                jnp.asarray(cnt), save_ckpt=True)
    jout, jckpt = np.asarray(jout), np.asarray(jckpt)
    neff = _np(tout)[:, 7, 0].astype(int)
    np.testing.assert_array_equal(neff, [1, 2])
    np.testing.assert_array_equal(neff, jout[:, 7, 0])
    for t in range(2):
        # chunk-start T with the done flag in the sign: the same prefix
        # products in another order than XLA's, 1e-5 of T's scale (1)
        a, b = jckpt[t, :neff[t]], _np(tckpt)[t, :neff[t]]
        assert np.abs(a - b).max() <= 1e-5
        np.testing.assert_array_equal(np.sign(a), np.sign(b))
    assert float(tckpt[0, 0].min()) == 1.0 and bool((tckpt[0, 1:] == 0).all())

    g = rng.normal(size=(2, 8, 256)).astype(np.float32)
    g[:, 6:] = 0.0
    trows = _np(ttiles.composite_tiles_bwd_plain(
        targs[0], targs[1], targs[3], torch.from_numpy(g), tout, tckpt, cfg,
        depth_grad=depth_grad))
    jd = np.asarray(jrp._bwd_call(jcfg, jinst, jnp.asarray(start), jnp.asarray(neff, np.int32),
                                  jnp.asarray(cnt), jnp.asarray(poff), jnp.asarray(g),
                                  jnp.asarray(jout), jnp.asarray(jckpt)))
    walked = np.zeros(len(inst), bool)
    for t in range(2):
        for i in range(neff[t]):
            m = min(CHUNK, cnt[t] - i * CHUNK)
            rows = slice(start[t] + i * CHUNK, start[t] + i * CHUNK + m)
            walked[rows] = True
            a = jd[:, poff[t] + i * CHUNK:poff[t] + i * CHUNK + m].T
            b = trows[rows]
            np.testing.assert_array_equal(b[:, ttiles._FID], inst[rows, ttiles._FID])
            np.testing.assert_array_equal(a[:, ttiles._FID], b[:, ttiles._FID])
            # per gradient row: f32 sums over 256 pixels and 128-lane scans
            # in another order, 1e-5 of the row's scale
            for c in range(10):
                scale = max(np.abs(a[:, c]).max(), 1e-12)
                assert np.abs(a[:, c] - b[:, c]).max() <= 1e-5 * scale, (t, i, c)
    assert walked[:128].all() and not walked[128:300].any()  # tile 0 stopped
    assert not trows[~walked].any()  # unwalked rows: zero grads, id 0
    if not depth_grad:
        assert not trows[:, 9].any()


def _scene(rng, n, spread=1.0, z0=5.0, scale_hi=0.15):
    means = (rng.normal(0, spread, (n, 3)) + [0, 0, z0]).astype(np.float32)
    scales = rng.uniform(0.02, scale_hi, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3)).astype(np.float32)
    return means, scales, quats, opac, shs


def _loss_weights(rng, w, h):
    return (rng.uniform(size=(3, h, w)).astype(np.float32),
            rng.uniform(size=(h, w)).astype(np.float32),
            rng.uniform(size=(h, w)).astype(np.float32))


@pytest.mark.parametrize("block", [(1, 1), (2, 2)])
def test_tiles_gradients_match_pallas_and_naive(block):
    """All five parameter gradients of the port's tiles backend (plain K1 +
    K2 on the CPU) against rasterize_pallas (interpret mode) and against
    the JAX naive oracle, 64x48, 150 gaussians; color, acc and depth
    cotangents (the depth term live: no drop contract at this level)."""
    rng = np.random.default_rng(11)
    w, h = 64, 48
    scene = _scene(rng, 150)
    gt, wa, wd = _loss_weights(rng, w, h)
    bg = np.asarray([0.2, 0.5, 0.8], np.float32)
    jc = jmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8)
    tc = tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")
    kw = dict(max_instances=1 << 13, capacity_slack=1.0, block_x=block[0],
              block_y=block[1])

    def jloss(render):
        def f(*a):
            out = render(*a)
            return (jnp.sum((out.color - gt) ** 2) + jnp.sum(out.acc * wa)
                    + 0.1 * jnp.sum(out.depth * wd))
        return f

    jargs = [jnp.asarray(a) for a in scene]
    g_pal = jax.grad(jloss(lambda *a: jrp.rasterize_pallas(
        *a, jc, bg_color=jnp.asarray(bg), interpret=True, **kw)),
        argnums=(0, 1, 2, 3, 4))(*jargs)
    g_naive = jax.grad(jloss(lambda *a: jref.rasterize_naive(
        *a, jc, bg_color=jnp.asarray(bg))), argnums=(0, 1, 2, 3, 4))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_(True) for a in scene]
    out = ttiles.rasterize_tiles(*targs, tc, bg_color=torch.from_numpy(bg), **kw)
    assert int(out.overflow) == 0
    loss = (((out.color - torch.from_numpy(gt)) ** 2).sum()
            + (out.acc * torch.from_numpy(wa)).sum()
            + 0.1 * (out.depth * torch.from_numpy(wd)).sum())
    loss.backward()
    for name, gp, gn, t in zip(("means", "scales", "quats", "opac", "shs"),
                               g_pal, g_naive, targs):
        b = _np(t.grad)
        for ref, atol, rtol in ((gp, 1e-5, 1e-4), (gn, 2e-4, 2e-3)):
            a = np.asarray(ref)
            scale = np.abs(a).max() + 1e-8
            np.testing.assert_allclose(b, a, atol=atol * scale, rtol=rtol,
                                       err_msg=f"grad {name}")


def test_depth_skipping_backward_matches_full():
    """With a zero depth cotangent, the backward that skips the depth term
    (depth_grad=False) gives the gradients of the full backward."""
    rng = np.random.default_rng(5)
    w, h = 48, 32
    scene = _scene(rng, 64)
    gt, wa, _ = _loss_weights(rng, w, h)
    tc = tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")
    grads = {}
    for dg in (True, False):
        targs = [torch.from_numpy(a).requires_grad_(True) for a in scene]
        out = ttiles.rasterize_tiles(*targs, tc, max_instances=1 << 13,
                                     block_x=2, block_y=2, depth_grad=dg)
        (((out.color - torch.from_numpy(gt)) ** 2).sum()
         + 0.1 * (out.acc * torch.from_numpy(wa)).sum()).backward()
        grads[dg] = [_np(t.grad) for t in targs]
    for a, b in zip(grads[True], grads[False]):
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
