"""Port parity: cameras, SH, covariance and preprocess of gslivm_tpu_torch
against gslivm_tpu on the same seeded numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models import cameras as jcams
from gslivm_tpu.ops import covariance as jcov
from gslivm_tpu.ops import rasterize_reference as jref
from gslivm_tpu.ops import sh as jsh
from gslivm_tpu_torch.models import cameras as tcams
from gslivm_tpu_torch.ops import covariance as tcov
from gslivm_tpu_torch.ops import rasterize_reference as tref
from gslivm_tpu_torch.ops import sh as tsh

torch.set_num_threads(1)

# f32 elementwise chains in the same order: only exp/sqrt/division rounding
# and XLA's contraction choices differ, a few ulp
RTOL, ATOL = 1e-5, 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _rot(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _cams(rng, w=64, h=48):
    R = _rot(rng) if rng is not None else np.eye(3)
    c = rng.normal(0, 0.2, 3) if rng is not None else np.zeros(3)
    return (jcams.make_camera(R, c, w, h, fovx=1.0, fovy=0.8),
            tcams.make_camera(R, c, w, h, fovx=1.0, fovy=0.8, device="cpu"))


def test_make_camera_fields_identical():
    jc, tc = _cams(np.random.default_rng(3))
    for f in ("R_cw", "t_cw", "fx", "fy", "tan_fovx", "tan_fovy", "cam_center", "K"):
        np.testing.assert_array_equal(_np(getattr(tc, f)), np.asarray(getattr(jc, f)))
    assert (tc.width, tc.height) == (jc.width, jc.height)
    jf = jcams.make_camera(np.eye(3), np.zeros(3), 64, 48, fx=50.0, fy=40.0)
    tf = tcams.make_camera(np.eye(3), np.zeros(3), 64, 48, fx=50.0, fy=40.0,
                           device="cpu")
    np.testing.assert_array_equal(_np(tf.K), np.asarray(jf.K))
    assert tcams.fov2focal(1.0, 64) == jcams.fov2focal(1.0, 64)
    assert tcams.focal2fov(50.0, 64) == jcams.focal2fov(50.0, 64)


def test_project_to_pixels_parity():
    rng = np.random.default_rng(4)
    jc, tc = _cams(rng)
    pts = rng.normal(0, 1, (50, 3)).astype(np.float32) + [0, 0, 4]
    pts = pts.astype(np.float32)
    jp, jz = jcams.project_to_pixels(jc, jnp.asarray(pts))
    tp, tz = tcams.project_to_pixels(tc, torch.from_numpy(pts))
    _close(tp, jp, atol=1e-4)  # pixel units, |pix| ~ 1e2
    _close(tz, jz)
    _close(tcams.world_to_cam(tc, torch.from_numpy(pts)),
           jcams.world_to_cam(jc, jnp.asarray(pts)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_color_parity(degree):
    rng = np.random.default_rng(10 + degree)
    n = 40
    k = tsh.num_sh_coeffs(degree)
    coeffs = rng.normal(0, 0.6, (n, k, 3)).astype(np.float32)
    means = (rng.normal(0, 2, (n, 3)) + [0, 0, 5]).astype(np.float32)
    campos = rng.normal(0, 0.3, 3).astype(np.float32)
    jout = jsh.sh_to_color(jnp.asarray(coeffs), jnp.asarray(means),
                           jnp.asarray(campos), degree)
    tout = tsh.sh_to_color(torch.from_numpy(coeffs), torch.from_numpy(means),
                           torch.from_numpy(campos), degree)
    _close(tout, jout)
    # the clamp at 0 is pinned too: negative raw colors come out exactly 0
    assert (_np(tout) == 0).sum() == (np.asarray(jout) == 0).sum()


def test_sh_rgb_roundtrip():
    rgb = torch.tensor([[0.2, 0.5, 0.9]])
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(rgb)), rgb, atol=1e-6)
    _close(tsh.rgb_to_sh(rgb), jsh.rgb_to_sh(jnp.asarray(rgb.numpy())))


def test_covariance_parity_unnormalized_quats():
    rng = np.random.default_rng(5)
    n = 60
    scales = rng.uniform(0.01, 0.4, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1.5, (n, 4)).astype(np.float32)  # NOT normalized
    jc3 = jcov.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3)
    tc3 = tcov.compute_cov3d(torch.from_numpy(scales), torch.from_numpy(quats), 1.3)
    _close(tc3, jc3, rtol=1e-5, atol=1e-6)
    _close(tcov.unpack_cov3d(tc3), jcov.unpack_cov3d(jc3), rtol=1e-5, atol=1e-6)
    _close(tcov.quat_to_rotmat(torch.from_numpy(quats)),
           jcov.quat_to_rotmat(jnp.asarray(quats)))

    jc, tc = _cams(rng)
    mv = (rng.normal(0, 1, (n, 3)) + [0, 0, 3]).astype(np.float32)
    mv[:3, 2] = [0.0, 1e-8, -0.5]  # degenerate depths hit the tz clamp
    jc2 = jcov.compute_cov2d(jnp.asarray(mv), jc3, jc.R_cw, jc.fx, jc.fy,
                             jc.tan_fovx, jc.tan_fovy)
    tc2 = tcov.compute_cov2d(torch.from_numpy(mv), tc3, tc.R_cw, tc.fx, tc.fy,
                             tc.tan_fovx, tc.tan_fovy)
    _close(tc2, jc2, rtol=2e-5, atol=1e-4)
    # the +0.3 low-pass sits on the diagonal of both
    assert float(tc2[:, 0].min()) >= 0.3 - 1e-6
    jcon, jrad, jdet = jcov.conic_and_radius(jc2)
    tcon, trad, tdet = tcov.conic_and_radius(tc2)
    _close(tcon, jcon, rtol=1e-4, atol=1e-5)
    _close(tdet, jdet, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(trad), np.asarray(jrad))

    big = np.array([[0.1, 0.2, 0.31], [0.1, 0.2, 0.29]], np.float32)
    np.testing.assert_array_equal(
        _np(tcov.scale_abnormal(torch.from_numpy(big))),
        np.asarray(jcov.scale_abnormal(jnp.asarray(big))))
    np.testing.assert_array_equal(_np(tcov.scale_abnormal(torch.from_numpy(big))),
                                  [True, False])


def _scene(rng, n, spread=1.0, z0=5.0, scale_hi=0.15):
    means = (rng.normal(0, spread, (n, 3)) + [0, 0, z0]).astype(np.float32)
    scales = rng.uniform(0.02, scale_hi, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    shs = rng.uniform(-0.3, 0.8, (n, 1, 3)).astype(np.float32)
    return means, scales, quats, opac, shs


def test_preprocess_parity():
    rng = np.random.default_rng(6)
    n = 200
    scene = list(_scene(rng, n, spread=1.5, z0=4.0, scale_hi=0.35))
    scene[0][:4, 2] = [0.1, -1.0, 0.2, 0.25]  # near-cull boundary cases
    active = np.ones(n, bool)
    active[-10:] = False
    jc, tc = _cams(rng)
    jp = jref.preprocess(*(jnp.asarray(a) for a in scene), jc,
                         active_mask=jnp.asarray(active))
    tp = tref.preprocess(*(torch.from_numpy(a) for a in scene), tc,
                         active_mask=torch.from_numpy(active))
    for f in ("valid", "rect_min", "rect_max", "tiles_touched", "radius"):
        np.testing.assert_array_equal(_np(getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    v = np.asarray(jp.valid)
    for f, atol in (("mean2d", 1e-4), ("conic", 1e-5), ("opacity", 0),
                    ("color", 1e-6), ("depth", 1e-6)):
        _close(_np(getattr(tp, f))[v], np.asarray(getattr(jp, f))[v],
               atol=atol)
    gx, gy = tref.tile_grid(64, 48)
    assert (gx, gy) == jref.tile_grid(64, 48)
    np.testing.assert_array_equal(_np(tref.depth_order(tp)),
                                  np.asarray(jref.depth_order(jp)))


def test_tile_min_power_parity():
    rng = np.random.default_rng(7)
    n = 300
    args = [rng.uniform(-40, 80, n), rng.uniform(-40, 80, n),
            rng.uniform(0.01, 0.5, n), rng.uniform(-0.1, 0.1, n),
            rng.uniform(0.01, 0.5, n)]
    args = [a.astype(np.float32) for a in args]
    tx = rng.integers(0, 4, n).astype(np.int32)
    ty = rng.integers(0, 3, n).astype(np.int32)
    for pw, ph in ((16, 16), (32, 32)):
        jq = jref.tile_min_power(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(tx), jnp.asarray(ty), pw, ph)
        tq = tref.tile_min_power(*(torch.from_numpy(a) for a in args),
                                 torch.from_numpy(tx), torch.from_numpy(ty), pw, ph)
        _close(tq, jq, rtol=1e-5, atol=1e-5)
