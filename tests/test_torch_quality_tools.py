"""Port parity of the map-quality tools (CPU): quality_bench's and
quality_diag's configuration overrides against the JAX tools', a short
training run of the JAX mapper and the port's from one carried-over state
across a prune (cameras, metrics, dropped count, the scheduled learning
rates step by step, the final PSNR), the inverse-depth L1 against the JAX
tool's formula, the oracle's splats against the JAX tool's stage_oracle,
and both CLIs at a toy size."""

import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.config import Config as JConfig
from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.config import GsOptimParams as JGs
from gslivm_tpu.frontend import synthetic as jsyn
from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu.models import training as jtraining
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu.pipeline import IncrementalMapper as JMapper
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.config import Config as TConfig
from gslivm_tpu_torch.config import GpParams as TGp
from gslivm_tpu_torch.config import GsOptimParams as TGs
from gslivm_tpu_torch.frontend import synthetic as tsyn
from gslivm_tpu_torch.ops import losses as tlosses
from gslivm_tpu_torch.pipeline import IncrementalMapper as TMapper
from gslivm_tpu_torch.tools import quality_bench, quality_diag

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
METRICS = ("loss", "image_loss", "simi", "delta", "psnr", "ssim")
STEPS = 5            # a prune after step 3, two steps after it
LR_MAX_STEPS = 6


def _load_jax_tool(name: str):
    """Import tools/<name>.py by path, putting sys.path back (the tool
    inserts the repo root)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                      ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path[:] = path


def _jax_diag_overrides(args) -> dict:
    """tools/quality_diag.py:78-88, the JAX tool's overrides by flag."""
    gs_over = dict(prune_interval=100, prune_max_scale=0.5)
    if not args.no_decay:
        gs_over.update(lr_max_steps=args.iters, position_lr_final=args.pos_lr_final,
                       scaling_lr_final=args.scale_lr_final)
    if args.feature_lr is not None:
        gs_over["feature_lr"] = args.feature_lr
    if args.position_lr is not None:
        gs_over["position_lr_init"] = args.position_lr
    if args.opacity_lr is not None:
        gs_over["opacity_lr"] = args.opacity_lr
    return gs_over


@pytest.mark.parametrize("argv", [[], ["--iters", "2000", "--grid", "0.2", "--pos-lr-final",
                                       "1e-5", "--scale-lr-final", "1e-3"]])
def test_quality_bench_config_matches_jax(argv):
    """The port's Config equals tools/quality_bench.py:64-76's, field by
    field, for the default and for overridden flags."""
    a = quality_bench.build_argparser().parse_args(argv)
    jcfg = JConfig(gp=JGp(grid=a.grid), gs=JGs(
        prune_interval=100, prune_max_scale=0.5, lr_max_steps=a.iters,
        position_lr_final=a.pos_lr_final, scaling_lr_final=a.scale_lr_final))
    assert dataclasses.asdict(quality_bench.make_config(a)) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("argv", [["init"], ["pipeline", "--no-decay"],
                                  ["oracle", "--iters", "90", "--feature-lr", "0.004",
                                   "--position-lr", "2e-4", "--opacity-lr", "0.05"]])
def test_quality_diag_overrides_match_jax(argv):
    """quality_diag's overrides (and the Config they make) equal the JAX
    tool's, and both tools take the same flags with the same defaults."""
    jdiag = _load_jax_tool("quality_diag")
    ja = jdiag.build_argparser().parse_args(argv)
    ta = quality_diag.build_argparser().parse_args(argv)
    assert vars(ja) == vars(ta)
    over = quality_diag.gs_overrides(ta)
    assert over == _jax_diag_overrides(ja)
    assert (dataclasses.asdict(TConfig(gp=TGp(grid=ta.grid), gs=TGs(**over)))
            == dataclasses.asdict(JConfig(gp=JGp(grid=ja.grid), gs=JGs(**over))))


def _recording(mapper, name):
    """Record every return value of mapper.<name>()."""
    got, fn = [], getattr(mapper, name)

    def record(*a, **k):
        got.append(fn(*a, **k))
        return got[-1]

    setattr(mapper, name, record)
    return got


def _gap_threshold(max_scales: np.ndarray) -> float:
    """A prune_max_scale in the widest relative gap between the 80th and
    95th percentile of the gaussians' largest scales: a few steps move a
    scale by far less than the gap, so both mappers drop the same set."""
    s = np.sort(max_scales)
    lo, hi = int(0.8 * len(s)), int(0.95 * len(s))
    k = lo + int(np.argmax(s[lo + 1:hi + 1] / s[lo:hi]))
    return float(np.sqrt(s[k] * s[k + 1]))


@pytest.fixture(scope="module")
def trained():
    """The JAX mapper and the port's ingest make_sequence(3, 48x36, 1500
    points), grid 0.5, with the quality overrides (lr_max_steps 6, a prune
    every 3 steps whose prune_max_scale drops some gaussians); the JAX
    map, Adam state, registry and anchors are carried into the port's
    mapper; then both take STEPS naive iterations. Returns both mappers and
    the records of each: cameras drawn, metrics, prunes, the scheduled
    learning rates (xyz, scaling) of every step."""
    gs = dict(prune_interval=3, prune_max_scale=0.5, lr_max_steps=LR_MAX_STEPS,
              position_lr_final=5e-5, scaling_lr_final=2.5e-4)
    jm = JMapper(config=JConfig(gp=JGp(grid=0.5), gs=JGs(**gs)),
                 settings=JSettings(backend="naive"), bootstrap_points=200,
                 initial_capacity=2500)
    tm = TMapper(config=TConfig(gp=TGp(grid=0.5), gs=TGs(**gs)), bootstrap_points=200,
                 initial_capacity=2500, device="cpu")
    for a, b in zip(jsyn.make_sequence(n_frames=3, width=48, height=36, points_per_frame=1500),
                    tsyn.make_sequence(n_frames=3, width=48, height=36,
                                       points_per_frame=1500, device="cpu")):
        jm.add_frame(a)
        tm.add_frame(b)
    n = int(jm.params.n_active)
    thr = _gap_threshold(np.exp(np.asarray(jm.params.scaling[:n])).max(axis=1))
    for m in (jm, tm):
        m.cfg = dataclasses.replace(m.cfg, gs=dataclasses.replace(m.cfg.gs, prune_max_scale=thr))
    with torch.no_grad():
        for f in convert.PARAM_FIELDS:
            getattr(tm.params, f).copy_(torch.from_numpy(np.array(getattr(jm.params, f))))
    convert.adam_state_from_numpy(tm.optimizer, tm.params, {
        f: {"mu": np.asarray(getattr(s.mu, f)), "nu": np.asarray(getattr(s.nu, f)),
            "count": np.asarray(s.count)}
        for f in FIELDS for s in [jm.opt_state.inner_states[f].inner_state[0]]})
    tm.registry = convert.registry_from_ranges(jm.registry._ranges)
    tm.loss_anchors = dict(jm.loss_anchors)
    tm._simi_cache = None

    rec = {}
    for key, m in (("jax", jm), ("port", tm)):
        rec[key] = {"drawn": _recording(m, "_sample_cameras"),
                    "prunes": _recording(m, "prune_map"), "metrics": [], "lr": []}
    groups = {g["name"]: g for g in tm.optimizer.param_groups}
    for _ in range(STEPS):
        counts = [int(jm.opt_state.inner_states[f].inner_state[1].count)
                  for f in ("xyz", "scaling")]
        rec["jax"]["lr"].append(counts)
        rec["jax"]["metrics"].append(jm.train_iteration())
        rec["port"]["metrics"].append(tm.train_iteration())
        st = tm.optimizer.state[tm.params.xyz]
        rec["port"]["lr"].append((groups["xyz"]["lr"], groups["scaling"]["lr"],
                                  int(st["step"]) - 1))
    return jm, tm, rec, thr


def test_short_run_across_a_prune_matches_jax(trained):
    """The same cameras drawn; step-1 metrics within rel 1e-5 (as
    test_torch_mapper); the same count dropped by the prune after step 3
    (some, by the max-scale test); keyframe 0's PSNR at the end within 0.1
    dB (Adam's first updates are about lr * sign(g), so a gradient at
    rounding level may step the other way)."""
    jm, tm, rec, thr = trained
    assert rec["port"]["drawn"] == rec["jax"]["drawn"] and len(rec["port"]["drawn"]) == STEPS
    for f in METRICS:
        assert float(getattr(rec["port"]["metrics"][0], f)) == pytest.approx(
            float(getattr(rec["jax"]["metrics"][0], f)), rel=1e-5), f
    assert all(np.isfinite(float(m.loss)) for m in rec["port"]["metrics"])
    assert rec["port"]["prunes"] == rec["jax"]["prunes"] and len(rec["jax"]["prunes"]) == 1
    assert rec["jax"]["prunes"][0] > 0, thr
    assert int(tm.params.n_active) == int(jm.params.n_active)
    jp = float(jlosses.psnr(jm.render_keyframe(0).color, jnp.asarray(jm.gt_images[0])))
    tp = float(tlosses.psnr(tm.render_keyframe(0).color, torch.from_numpy(tm.gt_images[0])))
    assert abs(tp - jp) <= 0.1, (tp, jp)


def test_scheduled_learning_rates_match_jax_across_the_prune(trained):
    """Step k of each mapper uses the schedule at k: the port's Adam `step`
    (which compact_opt_state keeps through the prune) equals optax's
    schedule count, and the xyz and scaling learning rates equal the JAX
    schedule's value at that count (the JAX schedule in f32: rel 1e-6)."""
    jm, _, rec, _ = trained
    gs = jm.cfg.gs
    sched = {"xyz": jtraining._log_lerp_schedule(gs.position_lr_init, gs.position_lr_final,
                                                 gs.lr_max_steps),
             "scaling": jtraining._log_lerp_schedule(gs.scaling_lr, gs.scaling_lr_final,
                                                     gs.lr_max_steps)}
    for k, ((jc_xyz, jc_sc), (lr_xyz, lr_sc, step)) in enumerate(
            zip(rec["jax"]["lr"], rec["port"]["lr"])):
        assert jc_xyz == jc_sc == step == k
        assert lr_xyz == pytest.approx(float(sched["xyz"](jc_xyz)), rel=1e-6)
        assert lr_sc == pytest.approx(float(sched["scaling"](jc_sc)), rel=1e-6)
    assert rec["port"]["lr"][-1][0] < rec["port"]["lr"][0][0]  # the decay went on


def test_inverse_depth_l1_matches_the_jax_formula(trained):
    """quality_bench.inverse_depth_l1 on the port mapper's render of
    keyframe 1 against the scene's ray-cast depth equals the formula of
    tools/quality_bench.py:136-143, within 1e-6."""
    _, tm, _, _ = trained
    out = tm.render_keyframe(1)
    gt_d = tsyn.render_depth(tm.cameras[1], tsyn.default_scene())
    rd, acc = out.depth.numpy(), out.acc.numpy()
    mask = (acc > 0.5) & np.isfinite(gt_d)
    inv_r = np.where(rd > 1e-2, 1.0 / np.maximum(rd, 1e-2), 0.0)
    inv_g = np.where(np.isfinite(gt_d), 1.0 / np.maximum(gt_d, 1e-2), 0.0)
    want = float(np.abs(inv_r - inv_g)[mask].mean())
    assert mask.any() and np.isfinite(want)
    assert abs(quality_bench.inverse_depth_l1(rd, acc, gt_d) - want) <= 1e-6


def test_stage_oracle_matches_jax(monkeypatch):
    """The port's stage_oracle plants the JAX tool's splats (xyz, rgb, cov
    and count to 1e-6) at the same capacity, and stages the same keyframes
    (GT images equal, SSIM statistics within 1e-6); the loss anchors stay
    empty and the mapper is started."""
    jdiag = _load_jax_tool("quality_diag")
    argv = ["oracle", "--spacing", "0.15", "--cov-frac", "0.4"]
    ja = jdiag.build_argparser().parse_args(argv)
    ta = quality_diag.build_argparser().parse_args(argv)
    seen = {}
    create = jgm.create_from_points

    def spy(batch, *a, **k):
        seen["batch"] = batch
        return create(batch, *a, **k)

    monkeypatch.setattr(jgm, "create_from_points", spy)
    jm = JMapper(settings=JSettings(backend="naive"), initial_capacity=16)
    jdiag.stage_oracle(jm, jsyn.make_sequence(2, 16, 12, 50), ja)
    tm = TMapper(initial_capacity=16, device="cpu")
    m = quality_diag.stage_oracle(tm, tsyn.make_sequence(2, 16, 12, 50, device="cpu"), ta,
                                  log=lambda *_: None)
    xyz, rgb, cov = quality_diag.oracle_points(ta.spacing, ta.cov_frac)
    jb = seen["batch"]
    assert m == xyz.shape[0] == int(jb.mask.sum()) == int(jm.params.n_active)
    assert int(tm.params.n_active) == m and tm.params.capacity == jm.params.capacity
    for a, b in ((xyz, jb.xyz), (rgb, jb.rgb), (cov, jb.cov)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm.params, f).detach().numpy(),
                                   np.asarray(getattr(jm.params, f)), rtol=0, atol=1e-6)
    assert len(tm.cameras) == len(jm.cameras) == 2 and tm.started and jm.started
    assert not tm.loss_anchors and not jm.loss_anchors
    for i in range(2):
        np.testing.assert_array_equal(tm.gt_images[i], jm.gt_images[i])
        for a, b in zip(tm._gt_stats[i], jm._gt_stats[i]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert tm.optimizer.param_groups[0]["params"][0] is tm.params.xyz


TOY = ["--cpu", "--width", "48", "--height", "36", "--keyframes", "3",
       "--points-per-frame", "1000", "--grid", "0.5", "--iters", "2", "--curve-every", "2"]


def test_quality_bench_main_prints_the_quality_keys(capsys, tmp_path):
    """main() at a toy size (a small capacity through `run`) prints one JSON
    object with QUALITY_r05.json's keys in its order and writes it to
    --out; the floor raises below it."""
    out = tmp_path / "q.json"
    res = quality_bench.main([*TOY, "--psnr-floor", "5", "--out", str(out)],
                             initial_capacity=2048)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = list(json.loads((ROOT / "QUALITY_r05.json").read_text()))
    assert list(printed) == list(res) == want == list(json.loads(out.read_text()))
    assert printed["device"] == "cpu" and printed["keyframes"] == 3
    assert printed["resolution"] == "48x36" and [c[0] for c in printed["psnr_curve"]] == [0, 2]
    assert np.isfinite(printed["final_psnr"]) and np.isfinite(printed["depth_l1_inv"])
    assert printed["min_keyframe_psnr"] == min(printed["per_keyframe_psnr"])
    with pytest.raises(AssertionError, match="below pinned floor"):
        quality_bench.check_floor({**printed, "psnr_floor": printed["final_psnr"] + 1})


def test_quality_diag_pipeline_main_writes_the_jax_keys(capsys, tmp_path):
    """quality_diag pipeline's main() at a toy size writes the JAX tool's
    result keys (and error-map PNGs) and prints DONE."""
    out = tmp_path / "d.json"
    quality_diag.main(["pipeline", *TOY, "--out", str(out), "--dump-dir", str(tmp_path / "dump")],
                      initial_capacity=2048)
    assert capsys.readouterr().out.strip().splitlines()[-1] == "DONE"
    res = json.loads(out.read_text())
    assert {"mode", "init_psnr", "gaussians", "config", "grid", "final_psnr", "psnr_curve",
            "iters", "train_s", "iters_per_s"} <= set(res)
    assert res["mode"] == "pipeline" and [c[0] for c in res["psnr_curve"]] == [2]
    assert len(res["final_psnr"]) == 3 and all(np.isfinite(r["psnr"]) for r in res["final_psnr"])
    dumped = {p.name for p in (tmp_path / "dump").iterdir()}
    for tag in ("init", "final"):
        worst = f"{tag}_kf{res['init_psnr' if tag == 'init' else 'final_psnr'][0]['kf']:02d}"
        assert any(n.startswith(tag) for n in dumped) and all(n.endswith(".png") for n in dumped)
        assert len([n for n in dumped if n.startswith(tag)]) % 2 == 0, (worst, dumped)


LONG = ["--cpu", "--width", "48", "--height", "30", "--keyframes", "4",
        "--points-per-frame", "1000", "--grid", "0.5", "--iters", "300", "--curve-every", "50"]


def _jax_quality_run(args, capacity: int) -> dict:
    """tools/quality_bench.py's flow (its overrides, ingest, the 6-keyframe
    PSNR curve, evaluate(), the inverse-depth L1 over the same keyframes) on
    the JAX mapper with the naive rasterizer, at a capacity the CPU holds
    (the tool fixes 2^17, which the naive O(P x pixels) path cannot)."""
    jm = JMapper(config=JConfig(gp=JGp(grid=args.grid), gs=JGs(
        prune_interval=100, prune_max_scale=0.5, lr_max_steps=args.iters,
        position_lr_final=args.pos_lr_final, scaling_lr_final=args.scale_lr_final)),
        settings=JSettings(backend="naive", max_instances=1 << 20), bootstrap_points=500,
        initial_capacity=capacity)
    for fr in jsyn.make_sequence(n_frames=args.keyframes, width=args.width,
                                 height=args.height, points_per_frame=args.points_per_frame):
        stats = jm.add_frame(fr)
    sample = np.linspace(0, len(jm.cameras) - 1, 6).astype(int)

    def sampled_psnr():
        return float(np.mean([float(jlosses.psnr(jm.render_keyframe(int(i)).color,
                                                 jnp.asarray(jm.gt_images[int(i)])))
                              for i in sample]))

    curve = [[0, sampled_psnr()]]
    for i in range(1, args.iters + 1):
        jm.train_iteration()
        if i % args.curve_every == 0:
            curve.append([i, sampled_psnr()])
    ev = jm.evaluate()
    planes, dls = jsyn.default_scene(), []
    for i in sample:
        out = jm.render_keyframe(int(i))
        gt_d = jsyn.render_depth(jm.cameras[int(i)], planes)
        rd, acc = np.asarray(out.depth), np.asarray(out.acc)
        mask = (acc > 0.5) & np.isfinite(gt_d)
        inv_r = np.where(rd > 1e-2, 1.0 / np.maximum(rd, 1e-2), 0.0)
        inv_g = np.where(np.isfinite(gt_d), 1.0 / np.maximum(gt_d, 1e-2), 0.0)
        dls.append(float(np.abs(inv_r - inv_g)[mask].mean()))
    return {"gaussians": int(stats["active"]), "psnr_curve": curve,
            "final_psnr": ev["mean_psnr"], "final_ssim": ev["mean_ssim"],
            "depth_l1_inv": float(np.mean(dls)), "n_active": int(jm.params.n_active)}


@pytest.mark.slow
def test_quality_run_tracks_the_jax_mapper_over_its_schedule():
    """quality_bench's whole flow, ingest to depth L1, on the port and on
    the JAX package (both f32 on the CPU, naive rasterizer, no state
    carried over) at 48x30, 4 keyframes, 300 iterations: the learning-rate
    decay over all of them and the prunes at steps 100, 200 and 300. The
    same gaussians after ingest and at the end; the sampled PSNR at every
    curve point and the final PSNR within 0.1 dB; SSIM within 1e-3; the
    inverse-depth L1 within 5% of the JAX run's. Prints both runs as one
    JSON line (pytest -s). About 15 minutes on one core, most of it the
    JAX package's naive rasterizer: run with --slow."""
    args = quality_bench.build_argparser().parse_args(LONG)
    cap = 2048
    want = _jax_quality_run(args, cap)
    got, info = quality_bench.run(args, initial_capacity=cap, log=lambda *_: None)
    print(json.dumps({"jax": want, "port": {
        **{k: got[k] for k in ("gaussians", "psnr_curve", "final_ssim", "depth_l1_inv")},
        "final_psnr": info["mean_psnr"], "n_active": info["gaussians_final"]}}))
    assert got["gaussians"] == want["gaussians"]
    assert info["gaussians_final"] == want["n_active"]
    assert [it for it, _ in info["prunes"]] == [100, 200, 300]
    assert [c[0] for c in got["psnr_curve"]] == [c[0] for c in want["psnr_curve"]]
    for (_, p), (_, q) in zip(got["psnr_curve"], want["psnr_curve"]):
        assert abs(p - q) <= 0.1, (got["psnr_curve"], want["psnr_curve"])
    assert abs(info["mean_psnr"] - want["final_psnr"]) <= 0.1
    assert abs(info["mean_ssim"] - want["final_ssim"]) <= 1e-3
    assert abs(info["depth_l1_inv"] - want["depth_l1_inv"]) <= 0.05 * want["depth_l1_inv"]
