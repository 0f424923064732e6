"""On the card: the program's served render against the plain reference
at a small size, the trace reader on it, and a roofline share under 100%.
Skipped without a card (the hand-written kernels have no CPU mode).

    python -m pytest --noconftest -q benchmark/tests/test_bench_cuda.py -m cuda
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import trace
from benchmark.reference import raster, roofline

W, H = 256, 192


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written CUDA kernels have no CPU mode")
    return torch.device("cuda")


def scene(dev, n: int = 4000):
    g = torch.Generator(device=dev).manual_seed(7)
    xyz = torch.rand((n, 3), generator=g, device=dev) * torch.tensor([3.0, 2.0, 2.0], device=dev) \
        + torch.tensor([-1.5, -1.0, 3.0], device=dev)
    return raster.Gaussians(
        xyz, torch.log(torch.rand((n, 3), generator=g, device=dev) * 0.05 + 0.01),
        torch.randn((n, 4), generator=g, device=dev),
        torch.randn((n, 1), generator=g, device=dev),
        torch.randn((n, 3), generator=g, device=dev))


def program_render(g, dev):
    from gslivm_tpu_torch.models.cameras import make_camera
    from gslivm_tpu_torch.ops.rasterize import RasterizeSettings, rasterize

    cam = make_camera(np.eye(3), np.zeros(3), W, H, fx=200.0, fy=200.0, device=dev)
    q = g.rotation / torch.linalg.norm(g.rotation, dim=-1, keepdim=True)
    with torch.no_grad():
        return rasterize(g.xyz, torch.exp(g.log_scale), q, torch.sigmoid(g.logit),
                         g.dc[:, None, :], cam, bg_color=torch.ones(3, device=dev),
                         settings=RasterizeSettings())


@pytest.mark.cuda
def test_the_served_render_agrees_with_the_reference(cuda):
    g = scene(cuda)
    out = program_render(g, cuda)
    v = raster.make_view(np.eye(3), np.zeros(3), W, H, 200.0, 200.0, torch.float64, cuda)
    ref = raster.render(raster.Gaussians(*(t.double() for t in g)), v,
                        torch.ones(3, dtype=torch.float64, device=cuda))
    assert int(out.overflow) == 0
    assert float(torch.sqrt(((out.color.double() - ref.color) ** 2).mean())) < 1e-5
    assert ref.pairs > 0


@pytest.mark.cuda
def test_the_trace_reads_k1_and_its_share_is_under_its_bound(cuda):
    g = scene(cuda)
    program_render(g, cuda)
    tracer = trace.Tracer(True)
    with tracer.window():
        for _ in range(5):
            with tracer.span("view"):
                program_render(g, cuda)
    w = tracer.result
    secs = trace.seconds_by_kernel(w.device)
    assert w.records_whole and 0 < w.busy_s <= w.window_s
    assert secs["K1"] > 0
    assert len(trace.in_spans(w.device, w.spans, "view")) > 0
    v = raster.make_view(np.eye(3), np.zeros(3), W, H, 200.0, 200.0, torch.float64, cuda)
    pairs, visible = raster.contributing_pairs(raster.Gaussians(*(t.double() for t in g)), v,
                                               torch.ones(3, dtype=torch.float64, device=cuda))
    share = 5 * roofline.k1_bound_s(pairs, visible, W * H) / secs["K1"]
    assert 0 < share <= 1.0
    b = trace.breakdown(w)
    assert b["device_ops"] and len(b["device_ops"]) <= 10
