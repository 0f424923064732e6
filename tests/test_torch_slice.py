"""The serving slice end to end on the CPU: the same map (carried over from
JAX state and through a PLY) rendered by both packages' render_params, then
scored with PSNR/SSIM/L1 against the same ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu.models import training as jtraining
from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import losses as jloss
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.models import gaussian_model as tgm
from gslivm_tpu_torch.models import training as ttraining
from gslivm_tpu_torch.ops import losses as tloss
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings as TSettings
from gslivm_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)
W, H, N = 64, 48, 150


def _map(seed):
    """A map in the JAX parameter layout, made the way chip_smoke.py makes
    its full-size one (log-scales, logit opacities, SH degree 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    op = rng.uniform(0.3, 0.9, (N,))
    return jgm.GaussianParams(
        xyz=jnp.asarray(rng.normal(0, 1.0, (N, 3)) + [0, 0, 4.0], jnp.float32),
        features_dc=jnp.asarray(rng.uniform(-0.3, 0.8, (N, 1, 3)), jnp.float32),
        features_rest=jnp.zeros((N, 0, 3), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.02, 0.08, (N, 3))), jnp.float32),
        rotation=jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True), jnp.float32),
        opacity=jnp.asarray(np.log(op / (1 - op))[:, None], jnp.float32),
        n_active=jnp.asarray(N - 5, jnp.int32),  # a padded tail renders nothing
    )


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1.0))


def test_serve_slice_matches_jax(tmp_path):
    jp = _map(0)
    jgm.save_ply(jp, str(tmp_path / "map.ply"))
    tp_ply = tgm.load_ply(str(tmp_path / "map.ply"), capacity=N, device="cpu")
    tp_np = convert.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in convert.PARAM_FIELDS}, device="cpu")
    assert int(tp_ply.n_active) == int(tp_np.n_active) == N - 5
    for f in convert.PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(tp_ply, f).detach().numpy()[:N - 5],
                                      np.asarray(getattr(jp, f))[:N - 5])

    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    bg = np.ones(3, np.float32)
    render = jax.jit(jtraining.render_params, static_argnames=("settings",))
    for center in ([0, 0, 0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0]):
        jc = jmake_camera(np.eye(3), np.asarray(center), W, H, fovx=1.2, fovy=0.8)
        tc = convert.camera_from_numpy(
            {**{f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_TENSOR_FIELDS},
             "width": W, "height": H}, device="cpu")
        jout = render(jp, jc, jnp.asarray(bg), settings=JSettings())
        with torch.no_grad():
            tnaive = ttraining.render_params(tp_ply, tc, torch.from_numpy(bg), TSettings())
            ttiles = ttraining.render_params(tp_np, tc, torch.from_numpy(bg),
                                             TSettings(backend="tiles"))
        # f32 compositing sums in another order: 1e-5 of the image scale
        for out in (tnaive, ttiles):
            for f in ("color", "depth", "acc"):
                assert _scaled_err(getattr(jout, f), getattr(out, f).numpy()) <= 1e-5, f
        assert int(ttiles.overflow) == 0

        jm = (float(jloss.psnr(jout.color, jnp.asarray(gt))),
              float(jloss.ssim(jout.color, jnp.asarray(gt))))
        tm = tmetrics.image_pair_metrics(ttiles.color, torch.from_numpy(gt))
        np.testing.assert_allclose(tm["psnr"], jm[0], rtol=1e-5)
        np.testing.assert_allclose(tm["ssim"], jm[1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            float(tloss.l1_loss(ttiles.color, torch.from_numpy(gt))),
            float(jloss.l1_loss(jout.color, jnp.asarray(gt))), rtol=1e-5)
