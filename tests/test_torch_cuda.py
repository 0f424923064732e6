"""K1 (with its checkpoints), K2, K3 and the tools' kernels T1 and T2 on
the card against their plain PyTorch versions, the tiles backend's
gradients against the naive backend's, a few train steps, the step
replayed from a CUDA graph against the eager step, and the
incremental mapper (GP ingest, growth, training, pruning), the LIVO front
end into a card mapper and a card checkpoint, and the camera intake's
integer ops (JPEG reconstruction, resize, remap) against the CPU, at small
shapes. CUDA kernels have no CPU mode, so every test here needs an NVIDIA
card with nvcc and skips elsewhere. Run on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from gslivm_tpu_torch import convert, kernels, pipeline
from gslivm_tpu_torch.config import Config, GpParams
from gslivm_tpu_torch.frontend import gpmap, synthetic
from gslivm_tpu_torch.models import training
from gslivm_tpu_torch.models.cameras import make_camera
from gslivm_tpu_torch.ops import (blur, gp3d, losses, rasterize, rasterize_reference,
                                  rasterize_tiles)
from gslivm_tpu_torch.tools import microbench_fwdablate, microbench_roll

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written CUDA kernels have no CPU mode")
    return torch.device("cuda")


# the supertiles binning takes: 1x1, the 2x2 default, and every shape of
# the block-shape sweep (tools/exp_block.py)
BLOCKS = [(1, 1), (2, 2), (2, 4), (3, 2), (2, 3), (4, 2)]


def _scene(rng, n, device):
    q = rng.normal(size=(n, 4))
    arrs = (rng.normal(0, 1.0, (n, 3)) + [0, 0, 4.0],
            rng.uniform(0.02, 0.12, (n, 3)),
            q / np.linalg.norm(q, axis=1, keepdims=True),
            rng.uniform(0.2, 0.95, (n,)),
            rng.uniform(-0.3, 0.8, (n, 1, 3)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrs]


@pytest.mark.parametrize("block", BLOCKS)
def test_k1_matches_plain_version(cuda, block):
    rng = np.random.default_rng(0)
    w, h = 160, 120  # the last supertile row overhangs the image
    cam = make_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device=cuda)
    pre = rasterize_reference.preprocess(*_scene(rng, 3000, cuda), cam)
    inst, binned, cfg = rasterize_tiles.prepare_tiles(
        pre, w, h, max_instances=1 << 16, block_x=block[0], block_y=block[1])
    args = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
    before = rasterize_tiles.composite_tiles.launches
    k = rasterize_tiles.composite_tiles(*args)
    torch.cuda.synchronize()
    assert rasterize_tiles.composite_tiles.launches == before + 1
    p = rasterize_tiles.composite_tiles_plain(*args)
    assert int(binned.tile_nchunks.max()) > 1  # several chunks and the vote
    # sequential compositing vs the plain version's prefix product: f32
    # rounding only, 1e-3 of each row's scale (the gate of the JAX bench)
    for row in range(6):
        scale = max(float(p[:, row].abs().max()), 1.0)
        assert float((k[:, row] - p[:, row]).abs().max()) / scale <= 1e-3, row
    # integer rows: at most 0.1% may flip on a rounding at the 1e-4 stop
    assert int((k[:, 6] != p[:, 6]).sum()) <= 1e-3 * k[:, 6].numel()
    assert int((k[:, 7, 0] != p[:, 7, 0]).sum()) <= 1e-3 * cfg.num_tiles + 1


def test_k1_vote_on_crafted_runs(cuda):
    """Tile 0 saturates inside its first chunk (neff 1 of 3), tile 1's run
    starts off a 128 boundary and never saturates (neff 2 of 2)."""
    rng = np.random.default_rng(7)
    cnt = torch.tensor([300, 200], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 300], dtype=torch.int32, device=cuda)
    nch = (cnt + 127) // 128
    inst = torch.zeros((500, rasterize_tiles.FEAT), device=cuda)
    inst[:, 0] = torch.as_tensor(rng.uniform(0, 32, 500), device=cuda)
    inst[:, 1] = torch.as_tensor(rng.uniform(0, 16, 500), device=cuda)
    inst[:, 2] = inst[:, 4] = 0.01
    inst[:300, 5] = 0.95
    inst[300:, 5] = 0.01
    inst[:, 6:10] = torch.as_tensor(rng.uniform(0, 2, (500, 4)), device=cuda)
    cfg = rasterize_tiles.TileConfig(grid_x=2, grid_y=1)
    k = rasterize_tiles.composite_tiles(inst, start, nch, cnt, cfg)
    p = rasterize_tiles.composite_tiles_plain(inst, start, nch, cnt, cfg)
    assert k[:, 7, 0].tolist() == p[:, 7, 0].tolist() == [1.0, 2.0]
    assert float((k[:, :6] - p[:, :6]).abs().max()) <= 1e-3 * max(float(p[:, :6].abs().max()), 1.0)


def test_k3_matches_plain_version_and_vjp(cuda):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(0, 1, (5, 70, 90)), dtype=torch.float32, device=cuda)
    taps = losses.gaussian_1d()
    before = blur.blur_cuda.launches
    y = blur.blur_cuda(x, taps)
    torch.cuda.synchronize()
    assert blur.blur_cuda.launches == before + 1
    assert float((y - blur.blur_plain(x, taps)).abs().max()) <= 1e-5
    xg = x.clone().requires_grad_(True)
    g = torch.rand_like(x)
    (dx,) = torch.autograd.grad(blur.blur_many(xg, taps), xg, g)
    xc = x.cpu().requires_grad_(True)
    (dxc,) = torch.autograd.grad(blur.blur_plain(xc, taps), xc, g.cpu())
    assert float((dx.cpu() - dxc).abs().max()) <= 1e-5


def _k3_case(rng, shape, k, device):
    """Uniform(0, 1) images and taps that sum to 1 (k = 11: the SSIM
    window), so that every output lies in [0, 1] like SSIM's."""
    if k == 11:
        taps = tuple(float(t) for t in losses.gaussian_1d())
    else:
        t = rng.uniform(0, 1, k)
        taps = tuple(float(v) for v in (t / t.sum()).astype(np.float32))
    x = torch.as_tensor(rng.uniform(0, 1, shape), dtype=torch.float32, device=device)
    return x, taps


@pytest.mark.parametrize("k", [1, 3, 4, 11, 15])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 21, 130), (9, 1080, 1920), (1, 1080, 1920)])
def test_k3_matches_plain_version_at_path_and_ragged_shapes(cuda, shape, k):
    """K3 (float4 or scalar instantiation, as the shape gives) against
    blur_plain in both tap orientations and through blur_many's VJP: max abs
    <= 1e-5 (f32 sums of k^2 taps in another order, FMA allowed)."""
    rng = np.random.default_rng(k)
    x, taps = _k3_case(rng, shape, k, cuda)
    before = blur.blur_cuda.launches
    for t in (taps, taps[::-1]):
        y = blur.blur_cuda(x, t)
        torch.cuda.synchronize()
        assert float((y - blur.blur_plain(x, t)).abs().max()) <= 1e-5
    assert blur.blur_cuda.launches == before + 2
    xg = x.clone().requires_grad_(True)
    g = torch.rand_like(x)
    (dx,) = torch.autograd.grad(blur.blur_many(xg, taps), xg, g)
    assert float((dx - blur.blur_plain(g, taps[::-1])).abs().max()) <= 1e-5


def test_k3_takes_the_scalar_instantiation_for_a_misaligned_view(cuda):
    """A contiguous view 4 bytes into its storage cannot take float4 rows:
    the wrapper picks the scalar instantiation from the pointer, launches
    once and matches blur_plain."""
    rng = np.random.default_rng(3)
    base = torch.as_tensor(rng.uniform(0, 1, 1 + 2 * 64 * 256), dtype=torch.float32,
                           device=cuda)
    x = base[1:].view(2, 64, 256)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert not blur.float4_rows(256, x.data_ptr(), 0)
    taps = losses.gaussian_1d()
    before = blur.blur_cuda.launches
    y = blur.blur_many(x, taps)
    torch.cuda.synchronize()
    assert blur.blur_cuda.launches == before + 1
    assert float((y - blur.blur_plain(x, taps)).abs().max()) <= 1e-5


@pytest.mark.parametrize("k", [1, 4, 11, 15])
@pytest.mark.parametrize("vec", [1, 0])
def test_k3_reports_its_resources(cuda, k, vec):
    """The runtime's report of one K3 instantiation: its 4 staged rows of
    528 floats, no dynamic shared memory, registers within the 255 a thread
    can have, and at least 4 blocks of 128 threads per SM."""
    u = kernels.usage("blur", k, vec)
    assert u["static_smem"] == 4 * 528 * 4 and u["dynamic_smem"] == 0, u
    assert 0 < u["registers"] <= 255 and u["blocks_per_sm"] >= 4, u


def test_tiles_on_card_matches_naive_with_grads(cuda):
    rng = np.random.default_rng(2)
    cam = make_camera(np.eye(3), np.zeros(3), 64, 48, fovx=1.0, fovy=0.8, device=cuda)
    scene = _scene(rng, 150, cuda)
    with torch.no_grad():
        tiles = rasterize.rasterize(*scene, cam)  # auto -> tiles on CUDA
        naive = rasterize.rasterize(*scene, cam,
                                    settings=rasterize.RasterizeSettings(backend="naive"))
    for f in ("color", "depth", "acc"):
        a, b = getattr(naive, f), getattr(tiles, f)
        assert float((a - b).abs().max()) / max(float(a.abs().max()), 1.0) <= 1e-3, f
    _grads_match_naive(cam, [x.requires_grad_(True) for x in scene], (2, 2))


def _grads_match_naive(cam, scene, block):
    """All five parameter gradients of the tiles backend (K1 + K2 on the
    card) against the naive backend's, scale-normalised <= 1e-3."""
    rng = np.random.default_rng(3)
    gt = torch.as_tensor(rng.uniform(size=(3, cam.height, cam.width)),
                         dtype=torch.float32, device=cam.device)
    grads = {}
    for backend in ("tiles", "naive"):
        before = rasterize_tiles.composite_tiles_bwd.launches
        out = rasterize.rasterize(*scene, cam, settings=rasterize.RasterizeSettings(
            backend=backend, block_x=block[0], block_y=block[1], max_instances=1 << 16))
        loss = ((out.color - gt) ** 2).sum() + 0.1 * out.acc.sum()
        grads[backend] = torch.autograd.grad(loss, scene)
        assert rasterize_tiles.composite_tiles_bwd.launches == before + (backend == "tiles")
    for name, a, b in zip(("means", "scales", "quats", "opac", "shs"),
                          grads["naive"], grads["tiles"]):
        scale = float(a.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-3 * scale, name


@pytest.mark.parametrize("block", BLOCKS)
def test_k1_checkpoints_and_k2_match_plain_versions(cuda, block):
    rng = np.random.default_rng(4)
    w, h = 160, 120  # the last supertile row overhangs the image
    cam = make_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device=cuda)
    pre = rasterize_reference.preprocess(*_scene(rng, 3000, cuda), cam)
    inst, binned, cfg = rasterize_tiles.prepare_tiles(
        pre, w, h, max_instances=1 << 16, block_x=block[0], block_y=block[1],
        contrib_stats=False)
    args = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
    k, ck = rasterize_tiles.composite_tiles(*args, save_ckpt=True)
    p, cp = rasterize_tiles.composite_tiles_plain(*args, save_ckpt=True)
    neff = k[:, 7, 0].long()
    assert int(neff.max()) > 1
    walked = torch.arange(cfg.max_chunks, device=cuda)[None, :] < neff[:, None]
    # chunk-start T below neff: f32 rounding of a sequential product vs a
    # prefix product; the done flag (the sign) flips on at most 0.1%
    assert float((ck.abs() - cp.abs())[walked].abs().max()) <= 1e-3
    assert int(((ck < 0) != (cp < 0))[walked].sum()) <= 1e-3 * int(walked.sum()) * cfg.npix
    _k2_matches_plain(inst, binned.sorted_start, binned.cnt_allowed, k, ck, cfg, rng,
                      binned.dorder.numel())
    scene = [x.requires_grad_(True) for x in _scene(rng, 400, cuda)]
    _grads_match_naive(make_camera(np.eye(3), np.zeros(3), 64, 48, fovx=1.0, fovy=0.8,
                                   device=cuda), scene, block)


def _k2_matches_plain(inst, start, cnt, tiles, ckpt, cfg, rng, n):
    """K2 (the gradient summed per gaussian) against its plain version, the
    per-instance rows summed by scatter_instance_grads, on identical
    inputs: per gradient row of the table, max abs difference over
    max(|plain row|, 1e-12) <= 1e-3 (f32 sums over the block's pixels in
    another order, the replay's sequential T against the prefix product,
    the later contributors' sum as the pixel total minus a running prefix,
    a gaussian's instances summed by atomics in run-to-run order)."""
    g = torch.as_tensor(rng.normal(size=tuple(tiles.shape)), dtype=torch.float32,
                        device=inst.device)
    g[:, 6:] = 0.0
    for depth_grad in (True, False):
        before = rasterize_tiles.composite_tiles_bwd.launches
        k = rasterize_tiles.composite_tiles_bwd(inst, start, cnt, g, tiles, ckpt, cfg,
                                                n, depth_grad)
        torch.cuda.synchronize()
        assert rasterize_tiles.composite_tiles_bwd.launches == before + 1
        p = rasterize_tiles.scatter_instance_grads(
            rasterize_tiles.composite_tiles_bwd_plain(inst, start, cnt, g, tiles, ckpt,
                                                      cfg, depth_grad), n, depth_grad)
        assert k.shape == p.shape == (rasterize_tiles.FEAT, n)
        for c in range(10):
            scale = max(float(p[c].abs().max()), 1e-12)
            assert float((k[c] - p[c]).abs().max()) <= 1e-3 * scale, (depth_grad, c)
        assert not bool(k[10:].any()) and (depth_grad or not bool(k[9].any()))


def test_k2_on_crafted_runs(cuda):
    """Tile 0 saturates inside its first chunk (neff 1 of 3): K2 walks only
    chunk 0 and adds nothing for the instances of chunks 1-2; tile 1's run
    starts off a 128 boundary. Each instance is its own gaussian."""
    rng = np.random.default_rng(7)
    cnt = torch.tensor([300, 200], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 300], dtype=torch.int32, device=cuda)
    nch = (cnt + 127) // 128
    inst = torch.zeros((500, rasterize_tiles.FEAT), device=cuda)
    inst[:, 0] = torch.as_tensor(rng.uniform(0, 32, 500), device=cuda)
    inst[:, 1] = torch.as_tensor(rng.uniform(0, 16, 500), device=cuda)
    inst[:, 2] = inst[:, 4] = 0.01
    inst[:300, 5] = 0.95
    inst[300:, 5] = 0.2
    inst[:, 6:10] = torch.as_tensor(rng.uniform(0, 2, (500, 4)), device=cuda)
    inst[:, rasterize_tiles._FID] = torch.arange(500, device=cuda, dtype=torch.float32)
    cfg = rasterize_tiles.TileConfig(grid_x=2, grid_y=1, max_chunks=8)
    k, ck = rasterize_tiles.composite_tiles(inst, start, nch, cnt, cfg, save_ckpt=True)
    assert k[:, 7, 0].tolist() == [1.0, 2.0]
    _k2_matches_plain(inst, start, cnt, k, ck, cfg, rng, 500)
    g = torch.ones_like(k)
    d = rasterize_tiles.composite_tiles_bwd(inst, start, cnt, g, k, ck, cfg, 500)
    assert bool(d[6, :128].abs().gt(0).any()) and not bool(d[:, 128:300].any())


def _crafted_tiles(rng, block, n, opac, clamped=False):
    """A binned scene built by hand: n gaussians on a 2x2 grid of
    (16 bx) x (16 by) pixel blocks, each gaussian's tile rect (whole 16x16
    tiles, as binning makes them) spanning a few tiles, so that rects end
    inside a block and straddle block edges; every block's run holds the
    gaussians whose rect meets it, in id order. With `clamped`, a third of
    the gaussians have opacity 1 and sit on a pixel centre, so alpha is
    clamped at 0.99 there. Returns the inputs of K1 and K2 and the number
    of tiles each gaussian is instanced in."""
    bx, by = block
    pw, ph = 16 * bx, 16 * by
    W, H = 2 * pw, 2 * ph
    feat = np.zeros((n, rasterize_tiles.FEAT), np.float32)
    x, y = rng.uniform(0, W, n), rng.uniform(0, H, n)
    radius = rng.uniform(4, 40, n)
    feat[:, rasterize_tiles._FO] = rng.uniform(*opac, n)
    if clamped:
        x[::3], y[::3] = np.floor(x[::3]), np.floor(y[::3])
        feat[::3, rasterize_tiles._FO] = 1.0
    feat[:, rasterize_tiles._FX], feat[:, rasterize_tiles._FY] = x, y
    feat[:, rasterize_tiles._FA] = feat[:, rasterize_tiles._FC] = 9.0 / radius**2
    feat[:, rasterize_tiles._FB] = rng.uniform(-0.2, 0.2, n) * 9.0 / radius**2
    feat[:, rasterize_tiles._FR:rasterize_tiles._FD + 1] = rng.uniform(0, 2, (n, 4))
    x0, x1 = np.floor((x - radius) / 16) * 16, np.ceil((x + radius) / 16) * 16
    y0, y1 = np.floor((y - radius) / 16) * 16, np.ceil((y + radius) / 16) * 16
    feat[:, rasterize_tiles._FX0], feat[:, rasterize_tiles._FX1] = x0, x1
    feat[:, rasterize_tiles._FY0], feat[:, rasterize_tiles._FY1] = y0, y1
    feat[:, rasterize_tiles._FID] = np.arange(n)
    runs = [np.flatnonzero((x0 < (bxi + 1) * pw) & (x1 > bxi * pw)
                           & (y0 < (byi + 1) * ph) & (y1 > byi * ph))
            for byi in range(2) for bxi in range(2)]
    gid = np.concatenate(runs)
    cnt = np.asarray([len(r) for r in runs], np.int32)
    start = (np.cumsum(cnt) - cnt).astype(np.int32)
    nch = ((cnt + 127) // 128).astype(np.int32)
    cfg = rasterize_tiles.TileConfig(grid_x=2, grid_y=2, pw=pw, ph=ph,
                                     rect_test=block != (1, 1), contrib_stats=True,
                                     max_chunks=8)
    return feat[gid], start, nch, cnt, cfg, np.bincount(gid, minlength=n)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("case", ["rect_edges", "done_mid_chunk", "alpha_clamped"])
def test_k1_k2_on_crafted_tiles(cuda, case, block):
    """K1 (rows, n_contrib, neff, checkpoints) and K2 against their plain
    versions on hand-built runs: warp patches whose tiles straddle the
    instances' tile-rect edges, pixels that finish mid-chunk, alpha clamped
    at 0.99; gaussians instanced in several blocks have their instances
    summed by K2's atomics. Gates as in the full-size checks."""
    rng = np.random.default_rng({"rect_edges": 30, "done_mid_chunk": 31,
                                 "alpha_clamped": 32}[case])
    n, opac = {"rect_edges": (400, (0.05, 0.4)), "done_mid_chunk": (1000, (0.7, 0.98)),
               "alpha_clamped": (400, (0.3, 0.9))}[case]
    inst_np, start, nch, cnt, cfg, mult = _crafted_tiles(
        rng, block, n, opac, clamped=case == "alpha_clamped")
    assert int(nch.max()) >= 2 and int(mult.max()) >= 3  # several chunks, shared gaussians
    inst = torch.as_tensor(inst_np, device=cuda)
    start, nch, cnt = (torch.as_tensor(a, device=cuda) for a in (start, nch, cnt))
    k, ck = rasterize_tiles.composite_tiles(inst, start, nch, cnt, cfg, save_ckpt=True)
    p, cp = rasterize_tiles.composite_tiles_plain(inst, start, nch, cnt, cfg, save_ckpt=True)
    for row in range(6):
        scale = max(float(p[:, row].abs().max()), 1.0)
        assert float((k[:, row] - p[:, row]).abs().max()) <= 1e-3 * scale, row
    assert int((k[:, 6] != p[:, 6]).sum()) <= 1e-3 * k[:, 6].numel() + 1
    assert torch.equal(k[:, 7, 0], p[:, 7, 0])
    neff = k[:, 7, 0].long()
    walked = torch.arange(cfg.max_chunks, device=cuda)[None, :] < neff[:, None]
    assert float((ck.abs() - cp.abs())[walked].abs().max()) <= 1e-3
    assert int(((ck < 0) != (cp < 0))[walked].sum()) <= 1e-3 * int(walked.sum()) * cfg.npix + 1
    if case == "done_mid_chunk":
        # pixels stop inside a chunk: some blocks end their walk early
        assert bool((neff < nch.long()).any())
    _k2_matches_plain(inst, start, cnt, k, ck, cfg, rng, n)


def test_k1_k2_take_the_plain_decisions_at_the_alpha_threshold(cuda):
    """Each of 1,024 splats has, at its own pixel, a power in [-5, -1] and
    an alpha within 2e-7 (relative, about two ulps) of the 1/255
    acceptance threshold. K1 and K2 must accept or reject each such pair as
    the plain versions do: n_contrib then agrees at every pixel and A,
    which one flipped decision moves by about 1/255, agrees to rounding.
    An exp that differs from torch.exp in its last bits (the hardware
    __expf, whose error grows with |power|) flips some of these
    decisions."""
    F = rasterize_tiles
    f32 = np.float32
    rng = np.random.default_rng(40)
    n_tiles, npix = 4, 256
    n = n_tiles * npix
    tile, j = np.repeat(np.arange(n_tiles), npix), np.tile(np.arange(npix), n_tiles)
    px = ((tile % 2) * 16 + j % 16).astype(f32)
    py = ((tile // 2) * 16 + j // 16).astype(f32)
    a = c = rng.uniform(0.2, 0.6, n).astype(f32)
    b = (a * rng.uniform(-0.05, 0.05, n)).astype(f32)
    r, phi = np.sqrt(2.0 * rng.uniform(1, 5, n) / a), rng.uniform(0, 2 * np.pi, n)
    x, y = (px + r * np.cos(phi)).astype(f32), (py + r * np.sin(phi)).astype(f32)
    # the power at the splat's pixel, in the kernels' order of f32 operations
    dx, dy = x - px, y - py
    power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
    o = (1.0 / 255.0 * (1.0 + rng.uniform(-2e-7, 2e-7, n)) / np.exp(power.astype(np.float64)))
    feat = np.zeros((n, F.FEAT), f32)
    for col, v in ((F._FX, x), (F._FY, y), (F._FA, a), (F._FB, b), (F._FC, c), (F._FO, o)):
        feat[:, col] = v
    feat[:, F._FR:F._FD + 1] = rng.uniform(0, 2, (n, 4))
    feat[:, F._FID] = np.arange(n)
    inst = torch.as_tensor(feat, device=cuda)
    cnt = torch.full((n_tiles,), npix, dtype=torch.int32, device=cuda)
    start = torch.arange(0, n, npix, dtype=torch.int32, device=cuda)
    nch = (cnt + 127) // 128
    cfg = F.TileConfig(grid_x=2, grid_y=2, max_chunks=8)
    # the plain version's own alphas at these pairs straddle the threshold
    t = {k: torch.as_tensor(v, device=cuda) for k, v in dict(a=a, b=b, c=c, dx=dx, dy=dy).items()}
    G = torch.exp(-0.5 * (t["a"] * t["dx"] * t["dx"] + t["c"] * t["dy"] * t["dy"])
                  - t["b"] * t["dx"] * t["dy"])
    raw = inst[:, F._FO] * G
    assert float((raw * 255.0 - 1.0).abs().max()) <= 5e-7 and float(inst[:, F._FO].max()) < 0.99
    assert 0.2 * n < int((raw >= 1.0 / 255.0).sum()) < 0.8 * n
    k, ck = F.composite_tiles(inst, start, nch, cnt, cfg, save_ckpt=True)
    p, cp = F.composite_tiles_plain(inst, start, nch, cnt, cfg, save_ckpt=True)
    flips = int((k[:, 6] != p[:, 6]).sum())
    assert flips == 0, f"{flips} pixels' n_contrib differ"
    assert float((k[:, :6] - p[:, :6]).abs().max()) <= 1e-5
    _k2_matches_plain(inst, start, cnt, k, ck, cfg, rng, n)


def test_k2_run_to_run_spread(cuda):
    """Five launches of K2 on one input (block 2x2, gaussians instanced in
    up to four blocks): the atomics sum a gaussian's instances in run-to-run
    order, so the outputs may differ by f32 rounding only, <= 1e-5 of each
    row's scale."""
    rng = np.random.default_rng(33)
    inst_np, start, nch, cnt, cfg, _ = _crafted_tiles(rng, (2, 2), 400, (0.05, 0.4))
    inst = torch.as_tensor(inst_np, device=cuda)
    start, nch, cnt = (torch.as_tensor(a, device=cuda) for a in (start, nch, cnt))
    k, ck = rasterize_tiles.composite_tiles(inst, start, nch, cnt, cfg, save_ckpt=True)
    g = torch.as_tensor(rng.normal(size=tuple(k.shape)), dtype=torch.float32, device=cuda)
    g[:, 6:] = 0.0
    runs = [rasterize_tiles.composite_tiles_bwd(inst, start, cnt, g, k, ck, cfg, 400)
            for _ in range(5)]
    for r in runs[1:]:
        for c in range(10):
            scale = max(float(runs[0][c].abs().max()), 1e-12)
            assert float((r[c] - runs[0][c]).abs().max()) <= 1e-5 * scale, c


def test_train_step_on_card_lowers_the_loss(cuda):
    rng = np.random.default_rng(5)
    n = 2000
    q = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.9, n)
    d = {"xyz": rng.normal(0, 1.0, (n, 3)) + [0, 0, 4.0],
         "features_dc": rng.uniform(-0.3, 0.8, (n, 1, 3)),
         "features_rest": np.zeros((n, 0, 3)),
         "scaling": np.log(rng.uniform(0.02, 0.08, (n, 3))),
         "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
         "opacity": np.log(opac / (1 - opac))[:, None], "n_active": n}
    cams = [make_camera(np.eye(3), np.asarray(c), 160, 120, fovx=1.0, fovy=0.8, device=cuda)
            for c in ([0, 0, 0], [0.05, 0, 0], [0, 0.05, 0])]
    settings = rasterize.RasterizeSettings(max_instances=1 << 17)
    bg = torch.ones(3, device=cuda)
    params = convert.params_from_numpy(d, device=cuda)
    with torch.no_grad():
        gt = torch.stack([training.render_params(params, c, bg, settings).color
                          for c in cams])
        params.features_dc += torch.as_tensor(
            0.2 * rng.normal(size=(n, 1, 3)), dtype=torch.float32, device=cuda)
    opt = training.make_optimizer(params)
    simi = training.empty_simi(device=cuda)
    before = rasterize_tiles.composite_tiles_bwd.launches
    losses_ = [training.train_step(params, opt, cams, gt, simi, settings=settings,
                                   n_history_pairs=1) for _ in range(5)]
    assert rasterize_tiles.composite_tiles_bwd.launches == before + 15
    vals = [float(m.loss) for m in losses_]
    assert all(np.isfinite(vals)) and vals[-1] < vals[0], vals
    assert all(int(m.overflow) == 0 for m in losses_)


@pytest.mark.parametrize("variant", microbench_roll.VARIANTS)
def test_t1_fetch_matches_plain_version(cuda, variant):
    """T1 on 64 tiles with ragged chunk counts, a first run that starts
    before the table and a last one that ends past it: f32 sums in another
    order, 1e-5 relative."""
    inst, off, nch = microbench_roll.make_inputs(variant, tiles=64, nch=3)
    nch[::5] = 1
    off[0] = -70
    off[-1] = inst.shape[1] - 200
    inst_t = convert.inst_from_numpy(inst, device=cuda)
    off_t, nch_t = torch.from_numpy(off).to(cuda), torch.from_numpy(nch).to(cuda)
    before = microbench_roll.fetch_sum.launches
    k = microbench_roll.fetch_sum(inst_t, off_t, nch_t, variant)
    torch.cuda.synchronize()
    assert microbench_roll.fetch_sum.launches == before + 1
    p = microbench_roll.fetch_sum_plain(inst_t, off_t, nch_t)
    assert float(((k - p).abs() / p.abs()).max()) <= 1e-5


@pytest.mark.parametrize("variant", microbench_fwdablate.VARIANTS)
def test_t2_chunk_walk_matches_plain_version(cuda, variant):
    """T2 on 4x2 tiles of 2 chunks, every third run cut to 200 instances
    (a partial chunk): sequential compositing against the plain version's
    prefix product, 1e-3 of each row's scale (K1's gate)."""
    inst, start, nch, cnt = microbench_fwdablate.build_inputs(4, 2, 2)
    cnt[::3] = 200
    args = (convert.inst_from_numpy(inst, device=cuda),
            *(torch.from_numpy(a).to(cuda) for a in (start, nch, cnt)))
    before = microbench_fwdablate.chunk_walk.launches
    k = microbench_fwdablate.chunk_walk(*args, 4, variant)
    torch.cuda.synchronize()
    assert microbench_fwdablate.chunk_walk.launches == before + 1
    p = microbench_fwdablate.chunk_walk_plain(*args, 4, variant)
    for row in range(8):
        scale = max(float(p[:, row].abs().max()), 1.0)
        assert float((k[:, row] - p[:, row]).abs().max()) <= 1e-3 * scale, row


def test_wrappers_reject_bad_inputs(cuda):
    cfg = rasterize_tiles.TileConfig(grid_x=1, grid_y=1)
    inst = torch.zeros((128, 16), device=cuda)
    i32 = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        rasterize_tiles.composite_tiles(inst, i32.long(), i32, i32, cfg)
    with pytest.raises(ValueError, match="float32"):
        blur.blur_cuda(torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda), [1.0])
    # 256 pixels, but not in whole 16x16 tiles
    with pytest.raises(ValueError, match="16x16 tiles"):
        rasterize_tiles.composite_tiles(inst, i32, i32, i32,
                                        rasterize_tiles.TileConfig(1, 1, pw=32, ph=8))


def test_tile_kernels_report_their_resources(cuda):
    """The runtime's report of K1 and K2 at 4 pixels a thread (the default
    2x2 supertile): the resident blocks per SM their launch bounds ask for
    (K1 4, K2 3) and K2's 48 KB of dynamic shared memory."""
    k1 = kernels.usage("tile_forward", 4)
    assert k1["blocks_per_sm"] >= 4 and k1["dynamic_smem"] == 0, k1
    assert k1["static_smem"] == 128 * 16 * 4, k1
    for depth_grad in (0, 1):
        k2 = kernels.usage("tile_backward", 4, depth_grad)
        assert k2["blocks_per_sm"] >= 3 and k2["dynamic_smem"] == 48 * 1024, k2
        assert 0 < k2["registers"] <= 80, k2


@pytest.mark.parametrize("variant", microbench_fwdablate.VARIANTS)
def test_t2_reports_k1s_residency(cuda, variant):
    """Each T2 variant keeps K1's launch bound: 4 blocks of 256 threads per
    SM, so at most 64 registers a thread, and at most K1's 8 KB shared batch."""
    u = kernels.usage("microbench_fwdablate", microbench_fwdablate.VARIANTS.index(variant))
    assert u["blocks_per_sm"] >= 4 and 0 < u["registers"] <= 64, u
    assert u["static_smem"] <= 128 * 16 * 4 and u["dynamic_smem"] == 0, u


def _scaled(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def test_gp_forward_and_colorize_on_card_match_the_cpu(cuda):
    """The same GP batches (two synthetic frames, grid 0.5) through
    gp_forward and colorize on the card and on the CPU: masks equal, values
    scale-normalised <= 1e-4 (batched Cholesky and einsums of two
    libraries in f32). TF32 must be off: it would move var_mean near its
    threshold."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    cfg = GpParams(grid=0.5)
    frames = synthetic.make_sequence(n_frames=2, width=96, height=64,
                                     points_per_frame=3000, device="cpu")
    gm_cpu = gpmap.GpMap(cfg, device="cpu")
    live = 0
    for fr in frames:
        div = gm_cpu.divide_points(fr.points_world)
        rc = gp3d.gp_forward(div.batch, cfg)
        rg = gp3d.gp_forward(gp3d.GpBatch(*(t.to(cuda) for t in div.batch)), cfg)
        for f in gp3d.GpResult._fields:
            a, b = getattr(rg, f).cpu(), getattr(rc, f)
            if b.dtype == torch.bool:
                assert torch.equal(a, b), f
            else:
                assert _scaled(a, b) <= 1e-4, f
        gm_cpu.update_variance(div.hashes, rc.reopen.numpy(), rc.update_variance.numpy())
        live += int(div.batch.mask.sum())
        proj = synthetic.camera_projection(fr.camera)
        image = torch.from_numpy(fr.image)
        cc, vc = gp3d.colorize(rc.means, proj, image)
        cg, vg = gp3d.colorize(rc.means.to(cuda), gp3d.CameraProjection(
            *(t.to(cuda) for t in proj)), image.to(cuda))
        assert torch.equal(vg.cpu(), vc) and torch.equal(cg.cpu(), cc)
    assert live > 50


def test_mapper_on_card_grows_trains_and_prunes(cuda):
    """Three 96x64 frames from a 1,024-row map: the capacity grows, 20
    steps train through K1, K2 and K3 with finite losses, a prune compacts
    the map, and the six Adam states keep `capacity` rows, keyed by the
    module's own Parameters."""
    cfg = Config(gp=GpParams(grid=0.5))
    mapper = pipeline.IncrementalMapper(config=cfg, initial_capacity=1024,
                                        bootstrap_points=200, device=cuda)
    for fr in synthetic.make_sequence(n_frames=3, width=96, height=64,
                                      points_per_frame=5000, device=cuda):
        mapper.add_frame(fr)
    assert mapper.params.capacity > 1024 and len(mapper.cameras) == 3
    counters = (rasterize_tiles.composite_tiles, rasterize_tiles.composite_tiles_bwd,
                blur.blur_cuda)
    before = [c.launches for c in counters]
    metrics = [mapper.train_iteration() for _ in range(20)]
    torch.cuda.synchronize()
    assert all(c.launches > b for c, b in zip(counters, before))
    assert all(np.isfinite(float(m.loss)) for m in metrics)
    n0 = int(mapper.params.n_active)
    cut = float(mapper.params.get_opacity().detach()[:n0, 0].quantile(0.1))
    dropped = mapper.prune_map(min_opacity=cut)
    assert 0 < dropped < n0 and int(mapper.params.n_active) == n0 - dropped
    assert np.isfinite(float(mapper.train_iteration().loss))
    for g in mapper.optimizer.param_groups:
        (p,) = g["params"]
        assert p is getattr(mapper.params, g["name"])
        st = mapper.optimizer.state[p]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == p.shape
        assert p.shape[0] == mapper.params.capacity
    ev = mapper.evaluate()
    assert ev["keyframes"] == 3 and np.isfinite(ev["mean_psnr"])


def test_concurrent_mapper_on_card_drains_and_joins(cuda):
    mapper = pipeline.IncrementalMapper(config=Config(gp=GpParams(grid=0.5)),
                                        initial_capacity=2048, bootstrap_points=200,
                                        device=cuda)
    cm = pipeline.ConcurrentMapper(mapper, iters_per_frame=3)
    for fr in synthetic.make_sequence(n_frames=3, width=96, height=64,
                                      points_per_frame=3000, device=cuda):
        cm.submit_frame(fr)
    assert cm.finish() is mapper
    assert cm.frames_mapped == 3 and cm.trained >= 3 and not cm._thread.is_alive()
    assert np.isfinite(float(cm.last_metrics.loss))


# K2's atomics sum in run-to-run order: its outputs, and the gradients
# through them, vary by up to this share of their scale from run to run
K2_SPREAD = 3.0e-7
COUNTED = (rasterize_tiles.composite_tiles, rasterize_tiles.composite_tiles_bwd,
           blur.blur_cuda)


def _graph_config():
    """Three cameras a step from the third keyframe on (window 1: one
    current camera and one history pair)."""
    return Config(gp=GpParams(grid=0.5, image_sliding_window=1, curr_cam_per_iter=1,
                              history_cam_per_iter=1))


def _graph_frames(device):
    return synthetic.make_sequence(n_frames=4, width=96, height=64, points_per_frame=5000,
                                   device=device)


def _grads(params):
    return [None if p.grad is None else p.grad.clone() for p in params.parameters()]


def _assert_grads_match(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (what, i)
        if w is not None and w.numel():
            assert _scaled(g, w) <= K2_SPREAD, (what, i, _scaled(g, w))


def test_graphed_step_matches_the_eager_step_from_one_state(cuda):
    """From one state and one draw of cameras: the eager step's gradient,
    then StepGraph's capture (and its replay) and a second replay. Loss
    and every leaf's .grad agree within K2's spread; each replay hands out
    metrics in tensors of their own; the launch counters count each
    replay's K1, K2 (one a render) and K3 (two a render), the capture
    nothing."""
    mapper = pipeline.IncrementalMapper(_graph_config(), initial_capacity=4800,
                                        bootstrap_points=200, device=cuda)
    for fr in _graph_frames(cuda)[:3]:
        mapper.add_frame(fr)
    curr, pairs = mapper._sample_cameras()
    idx = curr + [i for pr in pairs for i in pr]
    cams = [mapper.cameras[i] for i in idx]
    gts = [mapper._gt_device[i] for i in idx]
    stats = [mapper._gt_stats[i] for i in idx]
    simi = mapper._simi_inputs()
    args = (mapper.cfg.gs, mapper.settings, len(pairs), mapper._bg)
    assert len(cams) == 3 and training.graphable(mapper.params, mapper.settings)

    for p in mapper.params.parameters():
        p.grad = None
    eager = training.step_gradients(
        mapper.params, cams, torch.stack(gts), simi, *args,
        gt_stats=(torch.stack([s[0] for s in stats]), torch.stack([s[1] for s in stats])))
    want = _grads(mapper.params)

    sg = training.StepGraph()
    key = training.step_key(mapper.params, cams, len(pairs), simi, True, mapper.cfg.gs,
                            mapper.settings, mapper._bg)
    assert sg.stage(key, cams, gts, stats, simi) is None  # a new key: the eager step
    assert sg.stage(key, cams, gts, stats, simi) is not None
    before = [c.launches for c in COUNTED]
    first, captured = sg.run(mapper.params, *args)
    got1 = _grads(mapper.params)
    second, again = sg.run(mapper.params, *args)
    got2 = _grads(mapper.params)
    torch.cuda.synchronize()
    assert captured and not again
    assert [c.launches - b for c, b in zip(COUNTED, before)] == [6, 6, 12]
    for m in (first, second):
        assert abs(float(m.loss) - float(eager.loss)) <= K2_SPREAD * abs(float(eager.loss))
        for name in ("overflow", "num_instances", "max_nchunks", "walked_chunks"):
            assert int(getattr(m, name)) == int(getattr(eager, name)), name
    assert first.loss.data_ptr() != second.loss.data_ptr()
    _assert_grads_match(got1, want, "capture")
    _assert_grads_match(got2, want, "replay")


class _Eager(training.StepGraph):
    """A StepGraph that never stages: its mapper steps eagerly."""

    def stage(self, *args):
        return None


def _copy_state(src, dst):
    """dst's parameters, n_active and Adam state set to src's."""
    with torch.no_grad():
        for a, b in zip(src.params.parameters(), dst.params.parameters()):
            b.copy_(a)
        dst.params.n_active.copy_(src.params.n_active)
    for a, b in zip(src.params.parameters(), dst.params.parameters()):
        if a in src.optimizer.state:
            dst.optimizer.state[b] = {k: v.clone() for k, v in src.optimizer.state[a].items()}


def test_graphed_mapper_matches_an_eager_mapper_across_rekeys(cuda):
    """24 iterations of a graphed mapper and an eager twin, the twin set to
    the graphed mapper's state before each: a budget escalation (budgets
    too small at first), a capacity doubling through add_frame and a
    prune_map each change the key. Each iteration's loss and .grad agree
    within K2's spread; the first iteration at each key runs eagerly, the
    next captures, the rest replay; successive metrics are distinct
    tensors; the launch counters count one K1 and K2 and two K3 a render."""
    frames = _graph_frames(cuda)
    probe = pipeline.IncrementalMapper(_graph_config(), initial_capacity=1 << 16,
                                       bootstrap_points=200, device=cuda)
    for fr in frames[:3]:
        probe.add_frame(fr)
    full = int(probe.params.n_active)  # a capacity the fourth frame outgrows
    del probe
    settings = rasterize.RasterizeSettings(max_instances=2048, max_chunks_per_tile=8)
    graphed, eager = (pipeline.IncrementalMapper(_graph_config(), initial_capacity=full,
                                                 settings=settings, bootstrap_points=200,
                                                 device=cuda) for _ in range(2))
    eager._graph = _Eager()
    for fr in frames[:3]:
        graphed.add_frame(fr)
        eager.add_frame(fr)
    assert graphed.params.capacity == full
    modes, metrics, prev = [], [], None
    launched = [0, 0, 0]
    renders = 0
    for it in range(24):
        if it == 8:
            for m in (graphed, eager):
                m.add_frame(frames[3])
            assert graphed.params.capacity > full
        if it == 16:
            _copy_state(graphed, eager)
            n0 = int(graphed.params.n_active)
            cut = float(graphed.params.get_opacity().detach()[:n0, 0].quantile(0.1))
            assert graphed.prune_map(min_opacity=cut) == eager.prune_map(min_opacity=cut) > 0
        _copy_state(graphed, eager)
        state = (graphed.params.capacity, graphed.settings,
                 tuple(p.data_ptr() for p in graphed.params.parameters()))
        counts = (graphed.eager_steps, graphed.graph_captures, graphed.graph_replays)
        before = [c.launches for c in COUNTED]
        m_g = graphed.train_iteration()
        m_e = eager.train_iteration()
        launched = [n + c.launches - b for n, c, b in zip(launched, COUNTED, before)]
        renders += 3
        step = [a - b for a, b in zip((graphed.eager_steps, graphed.graph_captures,
                                       graphed.graph_replays), counts)]
        modes.append({(1, 0, 0): "eager", (0, 1, 1): "capture", (0, 0, 1): "replay"}[tuple(step)])
        want = "eager" if state != prev else ("capture" if modes[-2] == "eager" else "replay")
        assert modes[-1] == want, (it, modes)
        prev = state
        assert abs(float(m_g.loss) - float(m_e.loss)) <= K2_SPREAD * abs(float(m_e.loss)), it
        _assert_grads_match(_grads(graphed.params), _grads(eager.params), it)
        metrics.append(m_g)
    torch.cuda.synchronize()
    assert graphed.overflow_escalations >= 1 and eager.overflow_escalations >= 1
    assert modes.count("eager") >= 4 and modes.count("replay") >= 8, modes
    ptrs = [m.loss.data_ptr() for m in metrics]
    assert len(set(ptrs)) == len(ptrs)
    # both mappers' iterations, each one K1 and K2 and two K3 a render
    assert launched == [2 * renders, 2 * renders, 4 * renders]


def test_profiled_iterations_with_a_rekey_launch_each_kernel_once_a_render(cuda):
    """A profiled run of iterations that starts at a new key (eager, then
    capture and replays): one K1 and one K2 record a render and two K3."""
    mapper = pipeline.IncrementalMapper(_graph_config(), initial_capacity=4800,
                                        bootstrap_points=200, device=cuda)
    for fr in _graph_frames(cuda)[:3]:
        mapper.add_frame(fr)
    for _ in range(3):
        mapper.train_iteration()
    mapper.settings = mapper.settings._replace(
        max_chunks_per_tile=mapper.settings.max_chunks_per_tile + 8)
    torch.cuda.synchronize()
    counts = (mapper.eager_steps, mapper.graph_captures, mapper.graph_replays)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            mapper.train_iteration()
        torch.cuda.synchronize()
    assert (mapper.eager_steps - counts[0], mapper.graph_captures - counts[1],
            mapper.graph_replays - counts[2]) == (1, 1, 3)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    got = [sum(k in n for n in names) for k in ("tile_forward", "tile_backward", "blur")]
    assert got == [12, 12, 24], got


def test_concurrent_mapper_replays_while_the_front_end_uses_the_card(cuda):
    """ConcurrentMapper's worker captures and replays while the producer
    thread keeps the card busy and synchronises: the capture mode lets
    other threads use the card."""
    mapper = pipeline.IncrementalMapper(_graph_config(), initial_capacity=4800,
                                        bootstrap_points=200, device=cuda)
    cm = pipeline.ConcurrentMapper(mapper, iters_per_frame=6)
    x = torch.randn(256, 256, device=cuda)
    for fr in _graph_frames(cuda):
        cm.submit_frame(fr)
        for _ in range(20):
            x = torch.tanh(x @ x)
            torch.cuda.synchronize()
    assert cm.finish() is mapper
    assert mapper.graph_captures >= 1 and mapper.graph_replays >= 1, (
        mapper.eager_steps, mapper.graph_captures, mapper.graph_replays)
    assert np.isfinite(float(cm.last_metrics.loss)) and bool(torch.isfinite(x).all())


def _livo_on(device, sweeps=3):
    """The LIVO front end over `sweeps` sweeps of the e2e dolly at 96x64,
    its frames into a mapper on `device` (2 train iterations a frame)."""
    from gslivm_tpu_torch.config import IcpOptions, OdometryOptions
    from gslivm_tpu_torch.frontend.livo import LivoFrontend

    stream = synthetic.dolly_stream(sweeps, 96, 64, 12000)
    cfg = Config(gp=GpParams(grid=0.5),
                 odometry=OdometryOptions(init_num_frames=2, voxel_size=0.05,
                                          sample_voxel_size=0.6, init_voxel_size=0.05,
                                          init_sample_voxel_size=0.6),
                 icp=IcpOptions(min_number_neighbors=8, max_num_residuals=300,
                                size_voxel_map=0.5, num_iters_icp=6))
    fe = LivoFrontend(config=cfg, fx=stream.fx, fy=stream.fy, cx=stream.cx, cy=stream.cy,
                      width=96, height=64, device=device)
    mapper = pipeline.IncrementalMapper(config=cfg, initial_capacity=1024,
                                        bootstrap_points=50, device=device)
    for s in stream.init_imu:
        fe.push_imu(*s)
    for sw in stream.sweeps:
        fe.push_lidar(sw.lidar)
        for s in sw.imu:
            fe.push_imu(*s)
        fe.push_image(sw.image_time, sw.image)
        for fr in fe.pop_frames():
            assert fr.camera.device.type == fr.cam_projection.R_wc.device.type == device.type
            mapper.add_frame(fr)
            for _ in range(2):
                mapper.train_iteration()
    return cfg, mapper


def test_livo_sweeps_into_the_card_mapper(cuda):
    counters = (rasterize_tiles.composite_tiles, rasterize_tiles.composite_tiles_bwd,
                blur.blur_cuda)
    before = [c.launches for c in counters]
    _, mapper = _livo_on(cuda)
    torch.cuda.synchronize()
    assert mapper.started and len(mapper.cameras) >= 2
    assert all(c.launches > b for c, b in zip(counters, before))
    ev = mapper.evaluate()
    assert np.isfinite(ev["mean_psnr"])


def test_card_checkpoint_loads_on_the_card_and_on_the_cpu(cuda, tmp_path):
    from gslivm_tpu_torch.utils import checkpoint

    cfg, mapper = _livo_on(cuda)
    checkpoint.save_mapper(mapper, str(tmp_path))
    for device in (cuda, torch.device("cpu")):
        r = checkpoint.load_mapper(pipeline.IncrementalMapper(
            config=cfg, initial_capacity=1024, bootstrap_points=50, device=device),
            str(tmp_path))
        for a, b in zip(mapper.params.state_dict().values(), r.params.state_dict().values()):
            assert b.device.type == device.type and torch.equal(a.cpu(), b.cpu())
        for ga, gb in zip(mapper.optimizer.param_groups, r.optimizer.param_groups):
            sa = mapper.optimizer.state[ga["params"][0]]
            sb = r.optimizer.state[gb["params"][0]]
            assert all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)
        assert r.registry._ranges == mapper.registry._ranges
        assert r.cameras[0].device.type == device.type
        if device.type == "cuda":
            assert r.evaluate() == mapper.evaluate()
            assert np.isfinite(float(r.train_iteration().loss))


@pytest.mark.parametrize("block", [(1, 1), (2, 2)])
def test_band_and_slab_through_k1_k2_match_plain_versions(cuda, block):
    """A pixel band (band-local rows and rects) and a depth slab of a band
    through K1 with checkpoints and K2, against their plain versions; the
    slabs' partials fold to the single render within K1's gate plus the
    stop bound."""
    from gslivm_tpu_torch.parallel import primitive

    rng = np.random.default_rng(8)
    w, h = 160, 120
    cam = make_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device=cuda)
    pre = rasterize_reference.preprocess(*_scene(rng, 3000, cuda), cam)
    sgrid_y = -(-8 // block[1])
    rows = -(-sgrid_y // 2)
    slabs, overflow = primitive.split_depth_slabs(pre, 2)
    assert int(overflow) == 0
    for p in (pre, slabs[1]):
        inst, binned, cfg = rasterize_tiles.prepare_tiles(
            p, w, h, max_instances=1 << 16, block_x=block[0], block_y=block[1],
            contrib_stats=False, band_rows=rows, band_start=rows)
        assert cfg.grid_y == rows and int(binned.tile_nchunks.max()) >= 1
        args = (inst, binned.sorted_start, binned.tile_nchunks, binned.cnt_allowed, cfg)
        k, ck = rasterize_tiles.composite_tiles(*args, save_ckpt=True)
        q, _ = rasterize_tiles.composite_tiles_plain(*args, save_ckpt=True)
        for row in range(6):
            scale = max(float(q[:, row].abs().max()), 1.0)
            assert float((k[:, row] - q[:, row]).abs().max()) / scale <= 1e-3, row
        _k2_matches_plain(inst, binned.sorted_start, binned.cnt_allowed, k, ck, cfg, rng,
                          binned.dorder.numel())
    kw = dict(max_instances=1 << 16, block=block)
    parts = torch.stack([primitive.render_slab_band(s, w, h, sgrid_y, 0, **kw)[0]
                         for s in slabs])
    folded = primitive.fold_partials(parts)
    full, _, _ = rasterize_tiles.render_tiles_raw(pre, w, h, max_instances=1 << 16,
                                                  block_x=block[0], block_y=block[1])
    # the early stop fires per slab: where a walk stopped, the fold and the
    # one-pass render drop different light, within fold_stop_bound times
    # the largest splat colour (depth for D, 1 for A and T); else K1's gate
    bound = primitive.fold_stop_bound(parts, full[5])
    c, d = float(pre.color[pre.valid].max()), float(pre.depth[pre.valid].max())
    for row, peak in enumerate((c, c, c, d, 1.0, 1.0)):
        scale = max(float(full[row].abs().max()), 1.0)
        assert bool(((folded[row] - full[row]).abs() <= bound * peak + 1e-3 * scale).all()), row


def test_ssim_band_sum_through_k3_matches_the_cpu(cuda):
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (3, 90, 130)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.as_tensor(img, device=dev).requires_grad_(True)
        before = blur.blur_cuda.launches
        v = losses.ssim_band_sum(x, torch.as_tensor(gt, device=dev), 40, 30)
        (g,) = torch.autograd.grad(v, x)
        if dev.type == "cuda":
            assert blur.blur_cuda.launches == before + 2  # forward and VJP
        out[dev.type] = (float(v.detach()), g.cpu())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 1e-5 * float(
        out["cpu"][1].abs().max())


def test_sharded_step_in_a_one_rank_nccl_world(cuda, tmp_path):
    """multihost_demo's spawner on the card: one NCCL rank takes the tiles
    and primitive steps; the loss equals train_step's from the same map."""
    from gslivm_tpu_torch.tools import multihost_demo

    out = tmp_path / "out.pt"
    assert multihost_demo.main(["--nproc", "1", "--renderer", "tiles,primitive",
                                "--gauss", "2048", "--out", str(out), "--timeout", "120"]) == 0
    got = torch.load(out, weights_only=True)
    params, cams, gt, simi = multihost_demo.demo_scene(2048, 64, 48, cuda)
    opt = training.make_optimizer(params)
    m = training.train_step(params, opt, cams, gt, simi, settings=rasterize.RasterizeSettings(
        backend="tiles", max_instances=1 << 14, block_x=1, block_y=1))
    for spec, tol in (("tiles", 1e-5), ("primitive", 1e-4)):
        r = got[(1, spec)]
        assert r["metrics"]["loss"] == pytest.approx(float(m.loss), rel=tol), spec
        assert r["metrics"]["overflow"] == 0
        for f in ("xyz", "opacity", "features_dc"):
            want = getattr(params, f).grad.cpu()
            assert float((r["grads"][f] - want).abs().max()) <= 1e-3 * float(want.abs().max())


# ---- the camera intake: integer ops, so the card equals the CPU bit for bit ----

@pytest.mark.parametrize("sampling", [((1, 1),), ((1, 1), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)),
                                      ((1, 2), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
                                      ((4, 1), (1, 1), (1, 1))])
def test_jpeg_reconstruction_on_card_matches_the_cpu(cuda, sampling):
    """Gray, 4:4:4, 4:2:2, 4:4:0, 4:2:0 and 4:1:1 coefficient planes of a
    ragged 77x53 image (DC spread over the range, AC falling with
    frequency, so the clamps are hit) through dequantisation, IDCT,
    upsampling and colour conversion."""
    from gslivm_tpu_torch.frontend import jpeg

    rng = np.random.default_rng(len(sampling) + sampling[0][0] * 3 + sampling[0][1])
    w, h = 77, 53
    hmax, vmax = max(a for a, _ in sampling), max(b for _, b in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comps = tuple(jpeg.Component(i + 1, a, b, min(i, 1)) for i, (a, b) in enumerate(sampling))
    decay = 1.0 / (1.0 + np.add.outer(np.arange(8), np.arange(8)).reshape(64))
    blocks = [np.round(rng.normal(0, 40, (my * b, mx * a, 64)) * decay).astype(np.int16)
              for a, b in sampling]
    for blk in blocks:
        blk[..., 0] = rng.integers(-80, 80, blk.shape[:2])
    coefs = jpeg.Coefficients(w, h, comps, dict(enumerate(jpeg.quality_tables(75))), blocks)
    card = jpeg.reconstruct(coefs, cuda)
    assert card.device.type == "cuda" and card.shape == (h, w, 3)
    assert torch.equal(card.cpu(), jpeg.reconstruct(coefs, "cpu"))


def test_jpeg_decode_on_card_matches_the_cpu(cuda):
    """The port's encoder's 4:2:0 stream, entropy-decoded once on the host
    and reconstructed on the card and on the CPU."""
    from gslivm_tpu_torch.frontend import jpeg

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    coefs = jpeg.entropy_decode(jpeg.encode(img, 80))
    assert torch.equal(jpeg.reconstruct(coefs, cuda).cpu(), jpeg.reconstruct(coefs, "cpu"))
    np.testing.assert_array_equal(jpeg.decode(jpeg.encode(img, 95), cuda),
                                  jpeg.decode(jpeg.encode(img, 95), "cpu"))


@pytest.mark.parametrize("src,dst", [((128, 96), (64, 48)), ((128, 96), (77, 53)),
                                     ((96, 64), (200, 150))])
def test_resize_on_card_matches_the_cpu(cuda, src, dst):
    from gslivm_tpu_torch.frontend import imgproc

    img = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (src[1], src[0], 3),
                                                              dtype=np.uint8))
    card = imgproc.resize_linear(img.to(cuda), dst)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), imgproc.resize_linear(img, dst))


def test_remap_on_card_matches_the_cpu(cuda):
    """r3live.yaml's distortion at 320x256 (its K at ratio 0.25)."""
    from gslivm_tpu_torch.frontend import imgproc

    r = 0.25
    K = np.array([[863.4241 * r, 0, 640.6808 * r], [0, 863.4171 * r, 518.3392 * r], [0, 0, 1]])
    xy, fxy = imgproc.undistort_rectify_map(
        K, [-0.1080, 0.1050, -1.2872e-04, 5.7923e-05, -0.0222], (320, 256))
    maps = torch.from_numpy(xy), torch.from_numpy(fxy.astype(np.int32))
    img = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (256, 320, 3),
                                                              dtype=np.uint8))
    card = imgproc.remap_linear(img.to(cuda), *(m.to(cuda) for m in maps))
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), imgproc.remap_linear(img, *maps))


def test_stage_profiler_cuts_on_card_match_the_cpu(cuda):
    """profile_stages' cuts on a small bench scene through K1 and K2 against
    the CPU's plain versions (loss, five gradients, the backward cuts,
    1e-3 of scale: K1's and K2's gates); profile_binning's `+ sort` on the
    card gives bin_instances' gid_sorted; microbench_gridsample's variants
    agree on the card (its 1e-6 of scale)."""
    from gslivm_tpu_torch.tools import exp_block, microbench_gridsample, profile_binning
    from gslivm_tpu_torch.tools import profile_stages as ps

    kw = {**ps.BUDGETS, "max_instances": 1 << 14}
    (args_g, cam_g), (args_c, cam_c) = (exp_block.bench_scene(3000, 160, 96, d)
                                        for d in (cuda, "cpu"))
    assert _scaled(ps.full_loss(args_g, cam_g, kw).cpu(), ps.full_loss(args_c, cam_c, kw)) <= 1e-5
    for fn in (ps.full_grads, ps.kernel_grads):
        for g, c in zip(fn(args_g, cam_g, kw), fn(args_c, cam_c, kw)):
            assert _scaled(g.cpu(), c) <= 1e-3, fn.__name__
    before = rasterize_tiles.composite_tiles_bwd.launches
    st_g, st_c = ps.bwd_state(args_g, cam_g, kw), ps.bwd_state(args_c, cam_c, kw)
    for g, c in zip(ps.s_bwd_params(st_g), ps.s_bwd_params(st_c)):
        assert _scaled(g.cpu(), c) <= 1e-3
    assert rasterize_tiles.composite_tiles_bwd.launches == before + 1
    with torch.no_grad():
        pre = rasterize_reference.preprocess(*args_g, cam_g)
    geo = profile_binning.Geometry(cam_g.width, cam_g.height, 1 << 14, *profile_binning.BLOCK)
    b = ps.bin_pre(pre, cam_g, {**kw, "max_chunks_per_tile": profile_binning.MAXCH,
                                "capacity_slack": profile_binning.SLACK})
    cut = profile_binning.upto_sort(pre, geo)
    assert torch.equal((cut["key_sorted"] & 0xFFFFFFFF).int(), b.gid_sorted)
    inputs = microbench_gridsample.make_inputs(96, 128, cuda)
    diffs = microbench_gridsample.max_scaled_diffs(*inputs)
    assert max(diffs.values()) <= microbench_gridsample.TOL, diffs


def test_device_busy_splits_out_the_port_kernels(cuda):
    """timing.device_busy_ms names K1, K2 and K3 in the profiler's rows:
    a fwd+bwd shows K1 and K2 busy and no K3, a lone K3 call is all K3."""
    from gslivm_tpu_torch.tools import exp_block, timing
    from gslivm_tpu_torch.tools import profile_stages as ps

    args, cam = exp_block.bench_scene(3000, 160, 96, cuda)
    kw = {**ps.BUDGETS, "max_instances": 1 << 14}
    busy = timing.device_busy_ms(lambda: ps.kernel_grads(args, cam, kw), device=cuda)
    k = busy["kernel_busy_ms"]
    assert k["K1"] > 0 and k["K2"] > 0 and k["K3"] == 0, busy
    assert k["K1"] + k["K2"] < busy["device_busy_ms"]
    x = torch.rand(15, 64, 64, device=cuda)
    busy = timing.device_busy_ms(lambda: blur.blur_cuda(x, losses.gaussian_1d()), device=cuda)
    assert busy["kernel_busy_ms"]["K3"] == pytest.approx(busy["device_busy_ms"]), busy
