"""Port parity of the map container: activations, create_empty, the PLY
written by either package loading in the other, and the numpy carry-over
of JAX state (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.models import gaussian_model as tgm

torch.set_num_threads(1)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jparams(seed, n, cap, sh_degree):
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    p = jgm.create_empty(cap, sh_degree)
    return p.replace(
        xyz=p.xyz.at[:n].set(rng.normal(0, 2, (n, 3)).astype(np.float32)),
        features_dc=p.features_dc.at[:n].set(rng.normal(0, 1, (n, 1, 3)).astype(np.float32)),
        features_rest=p.features_rest.at[:n].set(
            rng.normal(0, 0.3, (n, k - 1, 3)).astype(np.float32)),
        scaling=p.scaling.at[:n].set(rng.uniform(-5, -2, (n, 3)).astype(np.float32)),
        rotation=p.rotation.at[:n].set(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacity=p.opacity.at[:n].set(rng.normal(0, 2, (n, 1)).astype(np.float32)),
        n_active=jnp.asarray(n, jnp.int32),
    )


def _fields(p):
    return {f: np.asarray(getattr(p, f)) for f in convert.PARAM_FIELDS}


@pytest.mark.parametrize("sh_degree", [0, 1, 3])
def test_params_from_numpy_and_activations(sh_degree):
    jp = _jparams(sh_degree, 30, 40, sh_degree)
    tp = convert.params_from_numpy(_fields(jp), device="cpu")
    assert isinstance(tp, torch.nn.Module)
    assert tp.capacity == jp.capacity and tp.sh_degree == jp.sh_degree
    assert int(tp.n_active) == 30
    for f in convert.PARAM_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))
    np.testing.assert_array_equal(_np(tp.active_mask()), np.asarray(jp.active_mask()))
    np.testing.assert_allclose(_np(tp.get_scaling()), np.asarray(jp.get_scaling()), rtol=1e-6)
    np.testing.assert_allclose(_np(tp.get_rotation()), np.asarray(jp.get_rotation()),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(tp.get_opacity()), np.asarray(jp.get_opacity()),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(tp.get_features()), np.asarray(jp.get_features()))
    names = {n for n, _ in tp.named_parameters()}
    assert names == set(convert.PARAM_FIELDS) - {"n_active"}
    assert "n_active" in dict(tp.named_buffers())


def test_create_empty_and_inverse_sigmoid():
    jp = jgm.create_empty(7, 2)
    tp = tgm.create_empty(7, 2, device="cpu")
    for f in convert.PARAM_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)))
    x = np.asarray([0.01, 0.3, 0.5, 0.99], np.float32)
    np.testing.assert_allclose(_np(tgm.inverse_sigmoid(torch.from_numpy(x))),
                               np.asarray(jgm.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_ply_crosses_between_packages(tmp_path, sh_degree):
    jp = _jparams(7 + sh_degree, 25, 32, sh_degree)
    # JAX writes, the port reads (into a larger capacity)
    jgm.save_ply(jp, str(tmp_path / "j.ply"))
    tp = tgm.load_ply(str(tmp_path / "j.ply"), sh_degree, capacity=40, device="cpu")
    assert int(tp.n_active) == 25 and tp.capacity == 40
    for f in convert.PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(_np(getattr(tp, f))[:25],
                                      np.asarray(getattr(jp, f))[:25], err_msg=f)
    # the port writes, JAX reads: byte-identical files from identical state
    tgm.save_ply(tp, str(tmp_path / "t.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = jgm.load_ply(str(tmp_path / "t.ply"), sh_degree)
    for f in convert.PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jp, f))[:25]
                                      if f != "n_active" else 25, err_msg=f)


def test_camera_from_numpy_identical():
    from gslivm_tpu.models.cameras import make_camera

    jc = make_camera(np.eye(3), np.asarray([0.1, 0.2, 0.3]), 64, 48, fovx=1.1, fovy=0.7)
    d = {f: np.asarray(getattr(jc, f)) for f in convert.CAMERA_TENSOR_FIELDS}
    tc = convert.camera_from_numpy({**d, "width": jc.width, "height": jc.height},
                                   device="cpu")
    for f in convert.CAMERA_TENSOR_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tc, f)), d[f])
    assert (tc.width, tc.height) == (64, 48)
