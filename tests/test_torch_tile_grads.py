"""The per-gaussian tile backward (K2's contract) on the CPU: the identity
K2's single replay rests on, checked in the plain versions, and the
per-gaussian gradient of the rank table (`composite_tiles_bwd`, whose CPU
path is the plain per-instance rows summed by `scatter_instance_grads`)
against the VJP of the JAX package's `_render_from_table` in Pallas
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import binning as jbin
from gslivm_tpu.ops import rasterize_pallas as jrp
from gslivm_tpu.ops import rasterize_reference as jref
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops import rasterize_reference as tref
from gslivm_tpu_torch.ops import rasterize_tiles as ttiles
from gslivm_tpu_torch.ops.binning import CHUNK

torch.set_num_threads(1)


def _scene(rng, n, spread=1.0, z0=5.0, scale_hi=0.15):
    means = (rng.normal(0, spread, (n, 3)) + [0, 0, z0]).astype(np.float32)
    scales = rng.uniform(0.02, scale_hi, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3)).astype(np.float32)
    return means, scales, quats, opac, shs


def _cotangents(rng, shape):
    g = rng.normal(size=shape).astype(np.float32)
    g[:, 6:] = 0.0  # n_contrib and neff carry no gradient
    return g


@pytest.mark.parametrize("depth_grad", [True, False])
def test_single_replay_identity_holds_in_plain_versions(depth_grad):
    """Psi = gC . (C_r, C_g, C_b) + gA A (+ gD D), from K1's rows 0-4, is the
    sum of w psi over every contributor of the pixel, so the suffix sum S_j
    of the two-replay backward equals Psi - P_j, P_j the inclusive prefix of
    w psi along the walk. Checked on every contributing pair of a 64x48
    render of 800 gaussians at block 2x2 (the rect test on): f32 sums of up
    to a few hundred terms in another order, 1e-5 of the pixel scale of
    Psi."""
    rng = np.random.default_rng(21)
    w, h = 64, 48
    cam = tmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")
    pre = tref.preprocess(*(torch.from_numpy(a) for a in _scene(rng, 800)), cam)
    inst, binned, cfg = ttiles.prepare_tiles(pre, w, h, max_instances=1 << 13,
                                             block_x=2, block_y=2, contrib_stats=False)
    start, cnt = binned.sorted_start.long(), binned.cnt_allowed.long()
    tiles, ckpt = ttiles.composite_tiles_plain(inst, binned.sorted_start,
                                               binned.tile_nchunks, binned.cnt_allowed,
                                               cfg, save_ckpt=True)
    g = torch.from_numpy(_cotangents(rng, tuple(tiles.shape)))
    gC0, gC1, gC2, gD, gA = (g[:, r:r + 1] for r in range(5))
    psi_total = gC0 * tiles[:, 0:1] + gC1 * tiles[:, 1:2] + gC2 * tiles[:, 2:3] + gA * tiles[:, 4:5]
    if depth_grad:
        psi_total = psi_total + gD * tiles[:, 3:4]
    scale = float(psi_total.abs().max())
    neff = tiles[:, 7, 0].long()
    assert int(neff.max()) > 1  # several chunks: the prefix carries across them

    t = torch.arange(cfg.num_tiles)
    px, py = ttiles._pixel_coords(t, cfg)
    prefix = torch.zeros_like(px)  # sum of w psi over the chunks walked so far
    per_chunk, contribs = [], []
    for i in range(int(neff.max())):
        work = i < neff
        feat, _, _ = ttiles._chunk_feats(inst, start, cnt, i, mask=work)
        T_signed = ckpt[:, i][:, None]
        m = ttiles._chunk_terms(feat, px, py, T_signed.abs(), T_signed < 0.0,
                                cfg.rect_test)
        psi = (gC0 * feat[:, :, ttiles._FR, None] + gC1 * feat[:, :, ttiles._FG, None]
               + gC2 * feat[:, :, ttiles._FB2, None] + gA)
        if depth_grad:
            psi = psi + gD * feat[:, :, ttiles._FD, None]
        wpsi = torch.where(work[:, None, None], m.w * psi, 0.0)
        per_chunk.append((prefix + ttiles._scan_rows(wpsi, torch.add, 0.0), wpsi))
        contribs.append(m.contrib & work[:, None, None])
        prefix = prefix + wpsi.sum(dim=1, keepdim=True)
    # the sum over every contributor is Psi
    assert float((prefix - psi_total).abs().max()) <= 1e-5 * scale
    # S_j the two-replay way (this chunk's suffix + every later chunk's sum)
    # against Psi - P_j, on the contributing pairs
    later = torch.zeros_like(px)
    n_pairs = 0
    for (P, wpsi), contrib in reversed(list(zip(per_chunk, contribs))):
        S = ttiles._suffix_excl(wpsi) + later
        diff = torch.where(contrib, (psi_total - P) - S, 0.0)
        assert float(diff.abs().max()) <= 1e-5 * scale
        later = later + wpsi.sum(dim=1, keepdim=True)
        n_pairs += int(contrib.sum())
    assert n_pairs > 1000


@pytest.mark.parametrize("pw, ph, ok", [(16, 16, True), (32, 32, True), (32, 64, True),
                                         (32, 8, False), (64, 4, False), (8, 32, False)])
def test_kernel_block_check_wants_whole_tiles(pw, ph, ok):
    """K1 and K2 tile a pixel block with whole 16x16 tiles (the warp patches
    of tile_common.cuh), so the check that their wrappers make before a
    launch refuses a block such as 32x8, although it holds 256 pixels."""
    cfg = ttiles.TileConfig(grid_x=1, grid_y=1, pw=pw, ph=ph)
    inst = torch.zeros((CHUNK, ttiles.FEAT))
    if ok:
        ttiles._check_inst_and_block(inst, cfg)
    else:
        with pytest.raises(ValueError, match="16x16 tiles"):
            ttiles._check_inst_and_block(inst, cfg)


@pytest.mark.parametrize("block", [(1, 1), (2, 2)])
def test_gaussian_grads_match_render_from_table_vjp(block):
    """The rank table's gradient from the port's tile backward (K1's plain
    version with checkpoints, then `composite_tiles_bwd` on the CPU) against
    jax.vjp of rasterize_pallas._render_from_table (its custom VJP: the
    Pallas backward kernel in interpret mode and the per-gaussian
    scatter-add), both fed JAX's own rank table and binning, 48x32, 120
    gaussians, the depth term live. f32 sums over pixels, 128-lane scans
    and a gaussian's instances in another order: 1e-5 of each row's
    scale."""
    rng = np.random.default_rng(13)
    w, h = 48, 32
    bx, by = block
    blocked = block != (1, 1)
    jc = jmake_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8)
    jp = jref.preprocess(*(jnp.asarray(a) for a in _scene(rng, 120)), jc)
    max_instances, max_chunks, slack = 1 << 12, 64, 1.0
    gx, gy = -(-((w + 15) // 16) // bx), -(-((h + 15) // 16) // by)
    jb = jbin.bin_instances(jp, w, h, max_instances, max_chunks, capacity_slack=slack,
                            block_x=bx, block_y=by, aligned_layout=False)
    table = jrp._build_rank_table(jp, jb.dorder, rect_rows=blocked)
    n = table.shape[1]
    jcfg = jrp.PallasConfig(grid_x=gx, grid_y=gy, max_chunks_per_tile=max_chunks,
                            interpret=True, pw=16 * bx, ph=16 * by, rect_test=blocked,
                            pad_cols=jbin._padded_capacity(max_instances, gx * gy, slack),
                            skip_contrib=True)
    gid_ext = jnp.concatenate([jb.gid_sorted, jnp.zeros((2 * CHUNK,), jnp.int32)])
    jtiles, vjp = jax.vjp(lambda tb: jrp._render_from_table(
        jcfg, tb, gid_ext, jb.sorted_start, jb.tile_nchunks, jb.cnt_allowed,
        jb.tile_offset), table)
    g = _cotangents(rng, tuple(jtiles.shape))
    (jd,) = vjp(jnp.asarray(g))
    jd = np.asarray(jd)

    cfg = ttiles.TileConfig(grid_x=gx, grid_y=gy, pw=16 * bx, ph=16 * by,
                            rect_test=blocked, contrib_stats=False, max_chunks=max_chunks)
    start, nch, cnt = (torch.from_numpy(np.array(a)) for a in
                       (jb.sorted_start, jb.tile_nchunks, jb.cnt_allowed))
    inst = torch.from_numpy(np.array(table)).t()[
        torch.from_numpy(np.array(jb.gid_sorted)).long()].contiguous()
    tiles, ckpt = ttiles.composite_tiles(inst, start, nch, cnt, cfg, save_ckpt=True)
    assert float((tiles[:, :6] - torch.from_numpy(np.array(jtiles))[:, :6]).abs().max()) <= 1e-5
    d = ttiles.composite_tiles_bwd(inst, start, cnt, torch.from_numpy(g), tiles, ckpt, cfg,
                                   n, depth_grad=True).numpy()
    assert d.shape == jd.shape == (ttiles.FEAT, n)
    assert int(tiles[:, 7, 0].max()) >= 1 and np.abs(jd[:10]).max() > 0
    for c in range(10):
        scale = max(np.abs(jd[c]).max(), 1e-12)
        assert np.abs(d[c] - jd[c]).max() <= 1e-5 * scale, c
    assert not d[10:].any() and not jd[10:].any()
