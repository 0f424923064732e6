"""The plain reference: its blocked composite against a brute force over
every pixel and every gaussian on a toy scene, its blocked gradient
against autograd of one unblocked composite, its losses, and its half-size
image against the program's camera intake."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import losses, raster

W, H = 64, 48


def toy(n: int = 180, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand((n, 3), generator=g, dtype=torch.float64) * torch.tensor([2.0, 1.5, 1.0]) \
        + torch.tensor([-1.0, -0.75, 2.0])
    return raster.Gaussians(
        xyz, torch.log(torch.rand((n, 3), generator=g, dtype=torch.float64) * 0.08 + 0.01),
        torch.randn((n, 4), generator=g, dtype=torch.float64),
        torch.randn((n, 1), generator=g, dtype=torch.float64) * 2.0,
        torch.randn((n, 3), generator=g, dtype=torch.float64))


def view():
    return raster.make_view(np.eye(3), np.zeros(3), W, H, 40.0, 40.0)


def brute_force(g, v, bg):
    """Every pixel over every gaussian in depth order, in numpy."""
    pre = raster.preprocess(g, v)
    valid = pre.valid.numpy()
    order = [i for i in np.argsort(pre.depth.numpy(), kind="stable") if valid[i]]
    m, cn, op = pre.mean2d.numpy(), pre.conic.numpy(), pre.opacity.numpy()
    col, dep = pre.color.numpy(), pre.depth.numpy()
    rmin, rmax = pre.rect_min.numpy(), pre.rect_max.numpy()
    img = np.zeros((3, H, W))
    pairs = 0
    for y in range(H):
        for x in range(W):
            T, c = 1.0, np.zeros(3)
            tx, ty = x // 16, y // 16
            for i in order:
                if not (rmin[i, 0] <= tx < rmax[i, 0] and rmin[i, 1] <= ty < rmax[i, 1]):
                    continue
                dx, dy = x - m[i, 0], y - m[i, 1]
                power = -0.5 * (cn[i, 0] * dx * dx + cn[i, 2] * dy * dy) - cn[i, 1] * dx * dy
                if power > 0:
                    continue
                a = min(0.99, op[i] * np.exp(power))
                if a < 1.0 / 255.0:
                    continue
                if T * (1 - a) < 1e-4:
                    break
                c += col[i] * a * T
                T *= 1 - a
                pairs += 1
            img[:, y, x] = c + T * bg
    return img, pairs


def test_the_blocked_render_and_its_pair_count_equal_a_brute_force():
    g, v = toy(), view()
    bg = torch.ones(3, dtype=torch.float64)
    r = raster.render(g, v, bg)
    img, pairs = brute_force(g, v, bg.numpy())
    assert r.pairs == pairs > 1000
    assert np.abs(r.color.numpy() - img).max() < 1e-12


def test_the_blocked_gradient_equals_autograd_of_one_composite(monkeypatch):
    g, v = toy(), view()
    bg = torch.ones(3, dtype=torch.float64)
    leaves = [t.detach().requires_grad_(True) for t in g]
    gg = raster.Gaussians(*leaves)
    w = torch.rand((3, H, W), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    raster.render(gg, v, bg, grad_color=w)
    blocked = [t.grad.clone() for t in leaves]
    monkeypatch.setattr(raster, "BLOCK", 4096)
    leaves2 = [t.detach().requires_grad_(True) for t in g]
    pre = raster.preprocess(raster.Gaussians(*leaves2), v)
    order = raster._order(pre)
    c = raster._composite(pre._replace(depth=pre.depth.detach()), order, 0, 0, W, H, bg)[0]
    (c * w).sum().backward()
    for a, b in zip(blocked, leaves2):
        assert torch.allclose(a, b.grad, rtol=1e-9, atol=1e-12)
    assert any(float(t.abs().max()) > 0 for t in blocked)


def test_the_ssim_blur_is_a_correlation_with_the_reference_window():
    x = torch.zeros((1, 21, 21), dtype=torch.float64)
    x[0, 10, 10] = 1.0
    taps = losses.window()
    out = losses.blur(x, taps)
    # a unit impulse at (10, 10) spreads to out[j] = taps[10 - j + 5]
    expect = np.outer(taps[::-1], taps[::-1])
    assert np.allclose(out[0, 5:16, 5:16].numpy(), expect)
    assert float(losses.ssim(x, x)) == pytest.approx(1.0)
