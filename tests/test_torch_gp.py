"""Port parity of GP ingest: the batched voxel GP (gp_forward), colorize,
the host voxel map (GpMap) and the synthetic frame source, against the
JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.frontend import synthetic as jsyn
from gslivm_tpu.frontend.gpmap import GpMap as JGpMap
from gslivm_tpu.ops import gp3d as jgp
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.config import GpParams as TGp
from gslivm_tpu_torch.frontend import synthetic as tsyn
from gslivm_tpu_torch.frontend.gpmap import GpMap as TGpMap
from gslivm_tpu_torch.ops import gp3d as tgp

torch.set_num_threads(1)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def _gp_batch(rng, grid=0.2, nt=10):
    """V = 16: 12 live cells (every direction; noisy and flat surfaces; three
    with a large sensor variance, which the gate reopens; one cell of ten
    copies of one point), one live cell of repeated points with zero
    variance (a singular K: the factorisation fails), 3 padding rows."""
    V = 16
    points = np.zeros((V, nt, 3), np.float32)
    variance = np.full((V, nt), 0.05, np.float32)
    direction = np.zeros(V, np.int32)
    region_min = np.zeros((V, 3), np.float32)
    mask = np.zeros(V, bool)
    for v in range(13):
        ijk = rng.integers(-20, 20, 3)
        d = v % 3
        f_axis = (0, 1, 2)[[2, 0, 1][d]]  # the regressed axis of direction d
        p = ijk * grid + rng.uniform(0, grid, (nt, 3))
        noise = 0.002 if v % 2 else 0.05
        p[:, f_axis] = ijk[f_axis] * grid + 0.5 * grid + rng.normal(0, noise, nt)
        if v >= 11:   # repeated points
            p[:] = p[0]
        points[v] = p
        direction[v] = d
        region_min[v] = ijk * grid
        mask[v] = True
        variance[v] = rng.uniform(0.01, 0.08, nt)
    variance[[0, 4, 8]] = 2.0
    variance[12] = 0.0
    return {"points": points, "variance": variance, "direction": direction,
            "region_min": region_min, "mask": mask}


def test_gp_forward_matches_jax():
    """Every GpResult field scale-normalised <= 1e-5 (the batched Cholesky
    solves and einsums of two libraries round apart in f32); the masks are
    equal. The singular cell is NaN in both."""
    rng = np.random.default_rng(0)
    b = _gp_batch(rng)
    cfg = JGp()
    jr = jgp.gp_forward(jgp.GpBatch(**{k: jnp.asarray(v) for k, v in b.items()}), cfg)
    tr = tgp.gp_forward(tgp.GpBatch(**{k: torch.from_numpy(v) for k, v in b.items()}), TGp())
    for f in tgp.GpResult._fields:
        a, t = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert a.shape == t.shape, f
        if a.dtype == bool:
            np.testing.assert_array_equal(t, a, err_msg=f)
            continue
        np.testing.assert_array_equal(np.isnan(t), np.isnan(a), err_msg=f)
        ok = ~np.isnan(a)
        assert _scaled_err(a[ok], t[ok]) <= 1e-5, f
    var_mean = np.asarray(jr.var_mean)
    assert np.isnan(var_mean[12]) and not np.isnan(var_mean[:12]).any()
    # the batch exercises both sides of the reopen gate
    assert 0 < int(np.asarray(jr.reopen).sum()) < 12


def test_colorize_matches_jax_at_the_image_border():
    rng = np.random.default_rng(1)
    h, w = 36, 48
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    proj = {"R_wc": np.eye(3, dtype=np.float32), "t_wc": np.zeros(3, np.float32),
            "fx": np.float32(40.0), "fy": np.float32(40.0), "cx": np.float32(23.5),
            "cy": np.float32(17.5), "dist": np.asarray([0.01, -0.002, 0.0, 0.0], np.float32)}
    # pixels on and just past every border, and points behind the camera
    uv = np.asarray([[0, 0], [-0.5, 3], [-1.0, 3], [w - 1, h - 1], [w - 0.999, 2],
                     [w, 2], [3, -0.5], [3, h], [23.5, 17.5]], np.float64)
    z = np.ones(len(uv))
    pts = np.stack([(uv[:, 0] - 23.5) / 40 * z, (uv[:, 1] - 17.5) / 40 * z, z], -1)
    pts = np.concatenate([pts, rng.normal(0, 1.0, (40, 3)) + [0, 0, 2.0],
                          [[0.1, 0.1, -2.0], [0.0, 0.0, 0.0]]]).astype(np.float32)
    jc, jv = jgp.colorize(jnp.asarray(pts), jgp.CameraProjection(
        **{k: jnp.asarray(v) for k, v in proj.items()}), jnp.asarray(image))
    tc, tv = tgp.colorize(torch.from_numpy(pts),
                          convert.cam_projection_from_numpy(proj, device="cpu"),
                          torch.from_numpy(image))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.float32
    assert 0 < int(tv.sum()) < len(pts)


def test_gpmap_batches_match_over_three_frames():
    """divide_points / update_variance on three synthetic frames: identical
    batches, hashes, loss anchors and cell statistics. Both maps take the
    JAX GP's variance updates (the port's own agree to 1e-5, see above, and
    would make the next batches' variances differ by that). Every third GP cell is
    reopened besides the gate's own choice (the synthetic surfaces pass
    the gate), so the reprocessing path runs too."""
    jf = jsyn.make_sequence(n_frames=3, width=48, height=36, points_per_frame=3000)
    jm, tm = JGpMap(JGp(grid=0.5)), TGpMap(TGp(grid=0.5), device="cpu")
    reopened = 0
    for fr in jf:
        jd, td = jm.divide_points(fr.points_world), tm.divide_points(fr.points_world)
        for f in jgp.GpBatch._fields:
            np.testing.assert_array_equal(getattr(td.batch, f).numpy(),
                                          np.asarray(getattr(jd.batch, f)), err_msg=f)
        for f in ("hashes", "loss_points", "loss_hashes"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
        jr = jgp.gp_forward(jd.batch, JGp(grid=0.5))
        tr = tgp.gp_forward(td.batch, TGp(grid=0.5))
        np.testing.assert_array_equal(tr.reopen.numpy(), np.asarray(jr.reopen))
        forced = td.batch.mask.numpy() & (np.arange(len(td.hashes)) % 3 == 0)
        jm.update_variance(jd.hashes, np.asarray(jr.reopen) | forced,
                           np.asarray(jr.update_variance))
        tm.update_variance(td.hashes, tr.reopen.numpy() | forced,
                           np.asarray(jr.update_variance))
        reopened += int(forced.sum())
        assert tm.stats() == jm.stats()
        assert tm._pending == jm._pending
    assert reopened > 0 and tm.stats()["converged"] > 0
    for h, cell in jm.cells.items():
        assert tm.cells[h].variance == cell.variance


def test_make_sequence_equals_jax_bit_for_bit():
    jf = jsyn.make_sequence(n_frames=2, width=64, height=48, points_per_frame=800)
    tf = tsyn.make_sequence(n_frames=2, width=64, height=48, points_per_frame=800,
                            device="cpu")
    for a, b in zip(jf, tf):
        assert b.image.dtype == np.uint8 and b.image.shape == (48, 64, 3)
        np.testing.assert_array_equal(b.image, a.image)
        np.testing.assert_array_equal(b.points_world, a.points_world)
        for f in ("R_cw", "t_cw", "fx", "fy", "tan_fovx", "tan_fovy", "cam_center", "K"):
            np.testing.assert_array_equal(getattr(b.camera, f).numpy(),
                                          np.asarray(getattr(a.camera, f)), err_msg=f)
        assert (b.camera.width, b.camera.height) == (a.camera.width, a.camera.height)
        for f in tgp.CameraProjection._fields:
            np.testing.assert_array_equal(getattr(b.cam_projection, f).numpy(),
                                          np.asarray(getattr(a.cam_projection, f)), err_msg=f)
    np.testing.assert_array_equal(tsyn.render_depth(tf[1].camera, tsyn.default_scene()),
                                  jsyn.render_depth(jf[1].camera, jsyn.default_scene()))
