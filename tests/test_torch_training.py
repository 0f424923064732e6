"""Port parity of the training step: the optimizer's groups and schedule,
expon_lr and LossMonitor, simi_loss, the delta-depth warp, and whole
train steps (render -> L1+SSIM -> simi -> delta-depth -> backward -> Adam)
against the JAX package's train_step on its naive backend (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu import config as jconfig
from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu.models import training as jtr
from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu_torch import config as tconfig
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.models import training as ttr
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops import losses as tlosses
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings as TSettings

torch.set_num_threads(1)

W, H = 64, 48
CENTERS = ([0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [0.0, 0.05, 0.0])
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def test_config_is_a_faithful_copy():
    for name in ("GsOptimParams", "GpParams", "ModelParams", "OdometryOptions",
                 "IcpOptions", "MapOptions", "CommonOptions", "Config"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tconfig, name))]
        assert [n for n, _ in jf] == [n for n, _ in tf], name
        for (n, a), (_, b) in zip(jf, tf):
            if not dataclasses.is_dataclass(a):
                assert a == b, (name, n)
    over = {"gs": {"feature_lr": 0.01}, "common": {"lidar_type": "ouster"}}
    assert (dataclasses.asdict(tconfig.load_config(over))
            == dataclasses.asdict(jconfig.load_config(over)))


def _map(rng, n=40, capacity=48):
    """The JAX parameter layout as numpy: n live gaussians in a capacity-
    padded buffer."""
    q = rng.normal(size=(capacity, 4))
    opac = rng.uniform(0.3, 0.9, (capacity,))
    return {
        "xyz": (rng.normal(0, 1.0, (capacity, 3)) + [0, 0, 5.0]).astype(np.float32),
        "features_dc": rng.uniform(-0.3, 0.8, (capacity, 1, 3)).astype(np.float32),
        "features_rest": np.zeros((capacity, 0, 3), np.float32),
        "scaling": np.log(rng.uniform(0.05, 0.2, (capacity, 3))).astype(np.float32),
        "rotation": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        "opacity": np.log(opac / (1 - opac))[:, None].astype(np.float32),
        "n_active": np.int32(n),
    }


def _jparams(d):
    return jgm.GaussianParams(**{f: jnp.asarray(v) for f, v in d.items()})


def _simi(rng, capacity=48, n=40):
    """500 anchor points near the map, 2048 gaussian indices, about half of
    each masked in."""
    return {
        "points": (rng.normal(0, 1.0, (jtr.MAX_SIMI, 3)) + [0, 0, 5.0]).astype(np.float32),
        "point_mask": rng.uniform(size=jtr.MAX_SIMI) < 0.5,
        "gauss_idx": rng.integers(0, n, 2048).astype(np.int32),
        "gauss_mask": rng.uniform(size=2048) < 0.5,
    }


def _jsimi(d):
    return jtr.SimiInputs(**{k: jnp.asarray(v) for k, v in d.items()})


def _cams():
    return ([jmake_camera(np.eye(3), np.asarray(c), W, H, fovx=1.0, fovy=0.8)
             for c in CENTERS],
            [tmake_camera(np.eye(3), np.asarray(c), W, H, fovx=1.0, fovy=0.8,
                          device="cpu") for c in CENTERS])


def test_optimizer_groups_and_schedule():
    p = jconfig.GsOptimParams(spatial_lr_scale=2.0, lr_max_steps=4,
                              position_lr_final=1e-6, scaling_lr_final=1e-6)
    params = convert.params_from_numpy(_map(np.random.default_rng(0), 4, 4),
                                       device="cpu")
    opt = ttr.make_optimizer(params, tconfig.GsOptimParams(**dataclasses.asdict(p)))
    assert [g["name"] for g in opt.param_groups] == list(jtr._GROUP_LR)
    for g in opt.param_groups:
        assert g["params"] == [getattr(params, g["name"])]
        assert g["lr"] == pytest.approx(jtr._GROUP_LR[g["name"]](p), rel=1e-12)
        assert g["eps"] == 1e-15 and g["betas"] == (0.9, 0.999)
    assert opt.param_groups[2]["lr"] == pytest.approx(p.feature_lr / 20.0)
    assert "n_active" not in dict(params.named_parameters())
    # the log-lerp schedule: step k uses optax's schedule at count k
    sched = {"xyz": jtr._log_lerp_schedule(2 * p.position_lr_init, 2 * 1e-6, 4),
             "scaling": jtr._log_lerp_schedule(2 * p.scaling_lr, 2 * 1e-6, 4)}
    for t in params.parameters():
        t.grad = torch.ones_like(t)
    for k in range(3):  # steps 0, 1 and the middle of the 4-step horizon
        ttr.apply_lr_schedule(opt)
        for g in opt.param_groups:
            want = (float(sched[g["name"]](k)) if g["name"] in sched
                    else jtr._GROUP_LR[g["name"]](p))
            assert g["lr"] == pytest.approx(want, rel=1e-6), (k, g["name"])
        opt.step()


def test_expon_lr_and_loss_monitor_match():
    for kw in ({}, {"lr_delay_steps": 10, "lr_delay_mult": 0.1}):
        for step in (0, 1, 5, 50, 100, 150):
            assert ttr.expon_lr(step, 1e-2, 1e-4, max_steps=100, **kw) == pytest.approx(
                jtr.expon_lr(step, 1e-2, 1e-4, max_steps=100, **kw), rel=1e-12)
    assert ttr.expon_lr(3, 0.0, 0.0) == 0.0
    a, b = ttr.LossMonitor(buffer_size=3), jtr.LossMonitor(buffer_size=3)
    for v in (10.0, 9.0, 9.0, 8.5, 8.5, 8.5, 8.5):
        assert a.update(v) == b.update(v)
        assert a.is_converging(0.1) == b.is_converging(0.1)


def test_simi_loss_and_grads_match():
    rng = np.random.default_rng(1)
    d, s = _map(rng), _simi(rng)
    jp, js = _jparams(d), _jsimi(s)
    jv, jg = jax.value_and_grad(jtr.simi_loss, allow_int=True)(jp, js)
    tp = convert.params_from_numpy(d, device="cpu")
    tv = ttr.simi_loss(tp, convert.simi_from_numpy(s, device="cpu"))
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-6)
    assert float(tv.detach()) > 0
    for f in ("xyz", "scaling"):
        assert _scaled_err(getattr(jg, f), _np(getattr(tp, f).grad)) <= 1e-5, f
    for f in ("features_dc", "rotation", "opacity"):  # xyz and scaling only
        assert getattr(tp, f).grad is None or not getattr(tp, f).grad.any()
    # no gaussian masked in: the loss is 0 and finite
    empty = ttr.empty_simi(max_gauss=64, device="cpu")
    assert float(ttr.simi_loss(tp, empty).detach()) == 0.0


def test_delta_depth_warp_and_loss_match():
    rng = np.random.default_rng(2)
    h, w = 29, 40
    jc = [jmake_camera(np.eye(3), np.asarray(c), w, h, fovx=1.0, fovy=0.8)
          for c in ([0, 0, 0], [0.06, 0.02, 0.0])]
    tc = [tmake_camera(np.eye(3), np.asarray(c), w, h, fovx=1.0, fovy=0.8,
                       device="cpu") for c in ([0, 0, 0], [0.06, 0.02, 0.0])]
    depth = rng.uniform(2.0, 8.0, (2, h, w)).astype(np.float32)
    depth[0, :5, :7] = 0.0  # background: the warp makes inf/NaN coordinates
    depth[0, 10, 20:] = 0.0
    acc = rng.uniform(0.0, 1.0, (2, h, w)).astype(np.float32)
    jw = np.asarray(jtr.delta_depth_warp(jnp.asarray(depth[0]), *jc))
    tw = _np(ttr.delta_depth_warp(torch.from_numpy(depth[0]), *tc))
    assert np.isfinite(tw).all() and np.isfinite(jw).all()
    # bilinear sampling in two formulations: f32 rounding of the weights
    assert _scaled_err(jw, tw) <= 1e-5
    assert (tw[:5, :7] == 0).all()
    jl = jtr.delta_depth_loss(jnp.asarray(depth[0]), jnp.asarray(acc[0]), jc[0],
                              jnp.asarray(depth[1]), jnp.asarray(acc[1]), jc[1])
    tl = ttr.delta_depth_loss(*(torch.from_numpy(x) for x in (depth[0], acc[0])), tc[0],
                              *(torch.from_numpy(x) for x in (depth[1], acc[1])), tc[1])
    # the warp's sample coordinates carry ~1e-5 px of f32 rounding from the
    # 3x3 products; this random depth map's slopes (up to 6 per pixel) and
    # 1/depth next to its zero-depth pixels amplify it to ~2e-5 of the loss
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)


def _step_inputs(seed):
    """A 40-gaussian map, three 64x48 cameras (the last two a history
    pair), GT = the naive render of the map before its features and
    positions were perturbed, the GT-side SSIM statistics, anchors."""
    rng = np.random.default_rng(seed)
    d = _map(rng)
    jc, tc = _cams()
    jset = JSettings(backend="naive")
    bg = jnp.ones(3)
    gt = np.stack([np.asarray(jtr.render_params(_jparams(d), c, bg, jset).color)
                   for c in jc])
    d["features_dc"] = d["features_dc"] + 0.2 * rng.normal(size=d["features_dc"].shape).astype(np.float32)
    d["xyz"] = d["xyz"] + 0.05 * rng.normal(size=d["xyz"].shape).astype(np.float32)
    return d, _simi(rng), jc, tc, gt


def _jax_steps(d, s, jc, gt, settings, n_steps):
    jp = _jparams(d)
    opt = jtr.make_optimizer(jtr.GsOptimParams())
    st = opt.init(jp)
    stats = jax.vmap(jlosses.ssim_ref_stats)(jnp.asarray(gt))
    metrics, grads = [], None
    for k in range(n_steps):
        jp, st, m = jtr.train_step(jp, st, jc, jnp.asarray(gt), _jsimi(s),
                                   settings=settings, n_history_pairs=1, gt_stats=stats)
        metrics.append(m)
        if k == 0:  # Adam's first moment after one step is (1 - 0.9) g
            grads = {f: np.asarray(getattr(st.inner_states[f].inner_state[0].mu, f)) / 0.1
                     for f in FIELDS}
            params1 = {f: np.asarray(getattr(jp, f)) for f in FIELDS}
    return metrics, grads, params1


def _torch_steps(d, s, tc, gt, settings, n_steps):
    tp = convert.params_from_numpy(d, device="cpu")
    opt = ttr.make_optimizer(tp)
    gtt = torch.from_numpy(gt)
    stats = [torch.stack(x) for x in zip(*(tlosses.ssim_ref_stats(g) for g in gtt))]
    simi = convert.simi_from_numpy(s, device="cpu")
    metrics, grads = [], None
    for k in range(n_steps):
        metrics.append(ttr.train_step(tp, opt, tc, gtt, simi, settings=settings,
                                      n_history_pairs=1, gt_stats=stats))
        if k == 0:
            grads = {f: _np(getattr(tp, f).grad) for f in FIELDS}
            params1 = {f: _np(getattr(tp, f)).copy() for f in FIELDS}
    assert int(tp.n_active) == 40  # the buffer is never optimised
    return metrics, grads, params1


METRICS = ("loss", "image_loss", "simi", "delta", "psnr", "ssim")


def test_train_steps_match_jax_naive():
    """One and three steps from identical state, the port on `auto` (naive
    on the CPU) against the JAX step on its naive backend.

    Tolerances: metrics rtol 1e-5 (f32 sums in another order). Gradients
    of step 1 scale-normalised <= 1e-5. Parameters after step 1 only where
    |g| > 1e-3 of its tensor's scale: Adam's first update with eps 1e-15 is
    about -lr * sign(g) whatever |g|, so a gradient at rounding level may
    flip sign and move its parameter by 2 lr; where |g| is well above
    rounding both sides take the same step, equal to f32 rounding of the
    update (atol 1e-6)."""
    d, s, jc, tc, gt = _step_inputs(3)
    jm, jg, jp1 = _jax_steps(d, s, jc, gt, JSettings(backend="naive"), 3)
    tm, tg, tp1 = _torch_steps(d, s, tc, gt, TSettings(), 3)
    for k in range(3):
        for f in METRICS:
            assert float(getattr(tm[k], f)) == pytest.approx(
                float(getattr(jm[k], f)), rel=1e-5), (k, f)
        assert int(tm[k].overflow) == 0
        assert int(tm[k].num_instances) == int(jm[k].num_instances)
    assert float(tm[2].loss) < float(tm[0].loss)
    assert float(tm[0].delta) > 0 and float(tm[0].simi) > 0
    for f in FIELDS:
        if jg[f].size == 0:
            continue
        assert _scaled_err(jg[f], tg[f]) <= 1e-5, f
        big = np.abs(jg[f]) > 1e-3 * np.abs(jg[f]).max()
        assert big.any()
        np.testing.assert_allclose(tp1[f][big], jp1[f][big], rtol=1e-5, atol=1e-6,
                                   err_msg=f)


def test_train_step_tiles_backend_matches_jax_naive():
    """The same step through the tiles backend on the CPU (the plain K1 and
    K2), at the oracle tolerance of the JAX package's tile-vs-naive test:
    gradients atol 2e-4 * scale, rtol 2e-3; metrics rtol 2e-3."""
    d, s, jc, tc, gt = _step_inputs(4)
    jm, jg, _ = _jax_steps(d, s, jc, gt, JSettings(backend="naive"), 1)
    tm, tg, _ = _torch_steps(d, s, tc, gt, TSettings(backend="tiles", max_instances=1 << 13), 1)
    for f in METRICS:
        assert float(getattr(tm[0], f)) == pytest.approx(float(getattr(jm[0], f)),
                                                         rel=2e-3), f
    assert int(tm[0].overflow) == 0 and int(tm[0].walked_chunks) > 0
    for f in FIELDS:
        if jg[f].size:
            scale = np.abs(jg[f]).max() + 1e-8
            np.testing.assert_allclose(tg[f], jg[f], atol=2e-4 * scale, rtol=2e-3,
                                       err_msg=f)


def test_delta_term_dead_under_drop_contract():
    """With depth_grad=False the delta-depth term carries no parameter
    gradient: the step equals one without history pairs, while the delta
    metric is still computed. With depth_grad=True the term is live."""
    d, s, _, tc, gt = _step_inputs(5)
    gtt = torch.from_numpy(gt)
    simi = convert.simi_from_numpy(s, device="cpu")

    def step(settings, pairs):
        tp = convert.params_from_numpy(d, device="cpu")
        m = ttr.train_step(tp, ttr.make_optimizer(tp), tc, gtt, simi,
                           settings=settings, n_history_pairs=pairs)
        return tp, m

    p_drop, m_drop = step(TSettings(), 1)
    p_none, m_none = step(TSettings(), 0)
    assert float(m_drop.delta) > 0 and float(m_none.delta) == 0
    for f in ("xyz", "scaling", "opacity"):
        np.testing.assert_array_equal(_np(getattr(p_drop, f)), _np(getattr(p_none, f)))
    p_live, m_live = step(TSettings(depth_grad=True), 1)
    assert np.isfinite(float(m_live.delta))
    assert not np.array_equal(_np(p_live.xyz), _np(p_none.xyz))
