"""Port parity of the incremental mapper: the port's IncrementalMapper and
the JAX package's ingest the same synthetic frames and train from them,
on the CPU (the port's `auto` backend is the naive oracle there, the JAX
mapper is asked for "naive"); and the budget feedback arithmetic fed the
same measurements."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.config import Config as JConfig
from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.frontend import synthetic as jsyn
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu.pipeline import IncrementalMapper as JMapper
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.config import Config as TConfig
from gslivm_tpu_torch.config import GpParams as TGp
from gslivm_tpu_torch.frontend import synthetic as tsyn
from gslivm_tpu_torch.ops import losses as tlosses
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings as TSettings
from gslivm_tpu_torch.pipeline import IncrementalMapper as TMapper

torch.set_num_threads(1)

METRICS = ("loss", "image_loss", "simi", "delta", "psnr", "ssim")
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _recording_sampler(mapper):
    """Record every (curr, hist_pairs) the mapper's sampler draws."""
    drawn, sample = [], mapper._sample_cameras

    def record():
        drawn.append(sample())
        return drawn[-1]

    mapper._sample_cameras = record
    return drawn


@pytest.fixture(scope="module")
def ingested():
    """make_sequence(3, 48x36, 5000 points), grid 0.5, as the JAX package's
    end-to-end test, ingested by the JAX mapper and the port's; the stats
    dicts of every add_frame. The initial capacity of 3,000 grows once to
    6,000 for the 5,927 gaussians: the JAX naive step composites every
    capacity row, so a tight capacity keeps its ten steps short."""
    jf = jsyn.make_sequence(n_frames=3, width=48, height=36, points_per_frame=5000)
    tf = tsyn.make_sequence(n_frames=3, width=48, height=36, points_per_frame=5000,
                            device="cpu")
    jm = JMapper(config=dataclasses.replace(JConfig(), gp=JGp(grid=0.5)),
                 settings=JSettings(backend="naive"), bootstrap_points=200,
                 initial_capacity=3000)
    tm = TMapper(config=dataclasses.replace(TConfig(), gp=TGp(grid=0.5)),
                 bootstrap_points=200, initial_capacity=3000, device="cpu")
    stats = [(tm.add_frame(b), jm.add_frame(a)) for a, b in zip(jf, tf)]
    return jm, tm, stats


def test_mapper_ingest_matches_jax_over_three_frames(ingested):
    """Every add_frame stats dict, the registry and the loss-anchor keys
    are equal: no GP or colour decision flips on this sequence. Parameters:
    scale-normalised <= 1e-5 (the GP's f32 solve rounds apart by ~1e-6 of
    the scene's scale: its samples move by ~5e-6 m in a 6 m scene).
    Scaling within 1e-5 m as the activated scale exp(s): a gaussian's scale
    is the spread of nine GP samples, so its error is bounded by theirs,
    not by a share of the largest scale; and log(sqrt(.)) of a near-zero
    covariance diagonal (a plane's normal axis, ~1e-9) magnifies the same
    rounding to ~5e-3 in s itself."""
    jm, tm, stats = ingested
    for t, j in stats:
        assert t == j
    assert tm.params.capacity == jm.params.capacity == 6000  # grew once
    assert tm.registry._ranges == jm.registry._ranges
    assert list(tm.loss_anchors) == list(jm.loss_anchors)
    # LiDAR hits exactly; a reopened voxel's GP samples to the GP's rounding
    ja = np.concatenate(list(jm.loss_anchors.values()))
    ta = np.concatenate(list(tm.loss_anchors.values()))
    assert ta.shape == ja.shape and np.abs(ta - ja).max() <= 1e-5 * np.abs(ja).max()
    assert set(tm._pending_color) == set(jm._pending_color)
    for f in ("xyz", "features_dc", "rotation", "opacity", "scaling"):
        a, t = np.asarray(getattr(jm.params, f)), getattr(tm.params, f).detach().numpy()
        if f == "scaling":
            assert np.abs(np.exp(a) - np.exp(t)).max() <= 1e-5
        else:
            assert np.abs(a - t).max() <= 1e-5 * np.abs(a).max(), f


def test_mapper_matches_jax_over_three_frames_and_ten_steps(ingested):
    """Ten steps from one state (the JAX mapper's after the ingest above,
    carried over with convert): identical cameras; step-1 metrics rtol 1e-5
    (as test_train_steps_match_jax_naive); keyframe 0's PSNR after ten
    steps within 0.1 dB (Adam's first updates are about lr * sign(g), so a
    gradient at rounding level near zero may step the other way)."""
    jm, tm, _ = ingested
    # train from ONE state: the JAX mapper's map, Adam state, registry and
    # anchors carried into the port's mapper in place
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

    jdrawn, tdrawn = _recording_sampler(jm), _recording_sampler(tm)
    jmet = [jm.train_iteration() for _ in range(10)]
    tmet = [tm.train_iteration() for _ in range(10)]
    assert tdrawn == jdrawn and len(tdrawn) == 10
    for f in METRICS:
        assert float(getattr(tmet[0], f)) == pytest.approx(float(getattr(jmet[0], f)),
                                                           rel=1e-5), f
    assert all(np.isfinite(float(m.loss)) for m in tmet)
    jp = float(jlosses.psnr(jm.render_keyframe(0).color, jnp.asarray(jm.gt_images[0])))
    tp = float(tlosses.psnr(tm.render_keyframe(0).color, torch.from_numpy(tm.gt_images[0])))
    assert abs(tp - jp) <= 0.1, (tp, jp)
    ev = tm.evaluate()
    assert ev["keyframes"] == 3 and np.isfinite(ev["mean_psnr"])


def test_budget_feedback_arithmetic_matches():
    """_ingest_budget_feedback / _maybe_shrink_budgets fed the same
    (overflow, num_instances, max_nchunks) measurements: the same
    max_instances and max_chunks_per_tile after every tuple, the JAX mapper
    on "pallas" and the port's on "tiles" (the backends whose budgets are
    fitted). The JAX mapper also takes the walked chunks, for its
    grad_capacity fit, which the port does not have, so refit counts are
    not compared."""
    jm = JMapper(settings=JSettings(backend="pallas"), initial_capacity=8)
    tm = TMapper(settings=TSettings(backend="tiles"), initial_capacity=8, device="cpu")
    rng = np.random.default_rng(0)
    feeds = []
    for phase, n in ((0, 120), (1, 6), (0, 160), (1, 3), (0, 120)):
        for _ in range(n):
            over = int(phase and rng.uniform() < 0.8) * int(rng.integers(1, 5000))
            feeds.append((over, int(rng.integers(20_000, 300_000)),
                          int(rng.integers(1, 30)), int(rng.integers(0, 9000))))
    shrunk = 0
    for t in feeds:
        jm._ingest_budget_feedback(*t)
        tm._ingest_budget_feedback(*t[:3])
        assert (tm.settings.max_instances, tm.settings.max_chunks_per_tile) == (
            jm.settings.max_instances, jm.settings.max_chunks_per_tile), t
        assert tm.overflow_escalations == jm.overflow_escalations
        shrunk += tm.settings.max_instances < 2**20
    assert tm.overflow_escalations >= 1 and tm.budget_refits >= 1 and shrunk > 0
    # the fit waits for the tile backend: naive budgets never move
    naive = TMapper(settings=TSettings(backend="naive"), initial_capacity=8, device="cpu")
    for _ in range(naive.budget_fit_window + 1):
        naive._maybe_shrink_budgets(1, 1)
    assert naive.settings == TSettings(backend="naive")
