"""K3's contract on the CPU: the port's blur_many (the plain version on CPU
tensors) and its VJP against the JAX package's Pallas blur kernel in
interpret mode, at shapes whose H is below a strip and whose W is neither a
multiple of 4 nor of 128, for odd and even tap counts; and the host-side
geometry that picks K3's instantiation (float4_rows) and its strip height
(strip_rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.ops import blur_pallas
from gslivm_tpu_torch.ops import blur, losses

torch.set_num_threads(1)

SHAPES = [(3, 37, 53), (2, 21, 130)]
TAPS = [1, 3, 4, 11, 15]


def _taps(k, rng):
    if k == 11:  # the SSIM window, asymmetric
        return tuple(float(t) for t in losses.gaussian_1d())
    return tuple(float(t) for t in rng.uniform(0, 1, k).astype(np.float32))


@pytest.mark.parametrize("k", TAPS)
@pytest.mark.parametrize("shape", SHAPES)
def test_blur_many_and_vjp_match_the_pallas_kernel(shape, k):
    """Forward and VJP within 1e-6 of the reference's max abs: f32 sums in
    another order (XLA's fusion in interpret mode against eager PyTorch)."""
    rng = np.random.default_rng(k * 100 + shape[2])
    taps = _taps(k, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: blur_pallas.blur_many(v, taps, True), jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(g))
    ref, ref_g = np.asarray(ref), np.asarray(ref_g)

    xt = torch.from_numpy(x).requires_grad_(True)
    out = blur.blur_many(xt, taps)
    (gt,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert out.shape == shape
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    assert np.abs(gt.numpy() - ref_g).max() <= 1e-6 * np.abs(ref_g).max()
    assert blur.blur_cuda.launches == 0  # CPU tensors never launch K3


@pytest.mark.parametrize(("w", "x_ptr", "y_ptr", "vec"), [
    (1920, 0, 512, True),
    (1920, 4, 512, False),    # a view 4 bytes into its storage
    (1920, 0, 8, False),
    (130, 0, 0, False),       # W not a multiple of 4
    (128, 1 << 20, 48, True),
])
def test_float4_rows_only_for_aligned_rows(w, x_ptr, y_ptr, vec):
    assert blur.float4_rows(w, x_ptr, y_ptr) is vec


# 660 and 792 resident blocks: 5 or 6 blocks of K3 per SM on 132 SMs
@pytest.mark.parametrize("resident", [660, 792])
@pytest.mark.parametrize(("shape", "strip"), [
    ((15, 1080, 1920), 128),  # one served view's SSIM stack: 540 blocks
    ((9, 1080, 1920), 64),    # a training camera's stack: 612 blocks
    ((6, 1080, 1920), 64),    # ssim_ref_stats' stack: 408 blocks
    ((1, 1080, 1920), 32),
    ((40, 1080, 1920), 128),  # past one wave at any strip: the tallest
    ((3, 37, 53), 32),
    ((2, 21, 130), 21),       # never taller than the image
])
def test_strip_is_the_shortest_that_fits_one_wave(shape, strip, resident):
    n, h, w = shape
    got = blur.strip_rows(n, h, w, resident)
    assert got == strip
    # the grid fits in one wave, unless no strip makes it fit
    blocks = n * -(-w // blur.BLOCK_COLS) * -(-h // got)
    assert blocks <= resident or got == blur.STRIPS[-1]
