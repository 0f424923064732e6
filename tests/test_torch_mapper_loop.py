"""The JAX package's mapper-loop tests, held for the port with the same
assertions (tests/test_pipeline.py): overflow escalation, the prune
lifecycle with the Adam state and registry carried along, the round-robin
camera sampler and the concurrent mapper. The port uses backend="tiles"
(the plain K1/K2 on the CPU) where the JAX tests say "pallas"."""

import dataclasses

import numpy as np
import pytest
import torch

from gslivm_tpu_torch.config import Config, GpParams, GsOptimParams
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.ops.losses import psnr
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
from gslivm_tpu_torch.pipeline import ConcurrentMapper, IncrementalMapper

torch.set_num_threads(1)


def _frames(n, points):
    return synthetic.make_sequence(n_frames=n, width=48, height=36,
                                   points_per_frame=points, device="cpu")


def test_overflow_detection_and_escalation():
    """Dense scene with a deliberately tiny instance budget: the overflow is
    surfaced in TrainMetrics and the mapper escalates max_instances until
    it vanishes."""
    cfg = dataclasses.replace(Config(), gp=GpParams(grid=0.5))
    mapper = IncrementalMapper(
        config=cfg,
        settings=RasterizeSettings(backend="tiles", max_instances=128,
                                   max_chunks_per_tile=1),
        bootstrap_points=200, initial_capacity=4096, device="cpu")
    for fr in _frames(2, 4000):
        mapper.add_frame(fr)

    m = mapper.train_iteration()
    assert int(m.overflow) > 0  # truncation detected, not silent
    budgets = [mapper.settings.max_instances]
    for _ in range(12):
        m = mapper.train_iteration()
        budgets.append(mapper.settings.max_instances)
        if int(m.overflow) == 0:
            break
    assert mapper.overflow_escalations >= 1
    assert budgets[-1] > budgets[0]
    assert int(m.overflow) == 0, f"budget growth never cleared overflow: {budgets}"


def test_camera_sampler_round_robin():
    """Every window camera is visited before any repeats (the exist-list +
    reset-on-exhaustion semantics of get_random_indices)."""
    cfg = dataclasses.replace(
        Config(), gp=GpParams(image_sliding_window=5, curr_cam_per_iter=1,
                              history_cam_per_iter=1))
    mapper = IncrementalMapper(config=cfg, initial_capacity=8, device="cpu")
    mapper.cameras = list(range(12))  # stand-ins; sampler only uses len()

    seen = []
    for _ in range(5):
        curr, _h = mapper._sample_cameras()
        seen += curr
    assert sorted(seen) == [7, 8, 9, 10, 11], seen
    seen2 = []
    for _ in range(5):
        curr, _h = mapper._sample_cameras()
        seen2 += curr
    assert sorted(seen2) == [7, 8, 9, 10, 11], seen2

    mapper._used_hist.clear()
    hist_seen = []
    for _ in range(6):
        _c, pairs = mapper._sample_cameras()
        hist_seen += [a for a, _b in pairs]
    assert sorted(set(hist_seen)) == [0, 1, 2, 3, 4, 5]
    _c, pairs = mapper._sample_cameras()
    assert all(b == a + 1 for a, b in pairs)


def test_prune_lifecycle_compacts_everything():
    """Low-opacity pruning drops gaussians, keeps Adam moments attached to
    their surviving gaussian, and remaps the hash registry so the simi loss
    keeps finding the right indices."""
    cfg = dataclasses.replace(Config(), gp=GpParams(grid=0.5),
                              gs=GsOptimParams(prune_interval=0))
    mapper = IncrementalMapper(
        config=cfg, settings=RasterizeSettings(backend="naive"),
        bootstrap_points=200, initial_capacity=4096, device="cpu")
    for fr in _frames(2, 4000):
        mapper.add_frame(fr)
    for _ in range(2):
        mapper.train_iteration()

    n0 = int(mapper.params.n_active)
    kill = np.zeros(mapper.params.capacity, bool)
    kill[:n0:3] = True
    with torch.no_grad():
        mapper.params.opacity[torch.from_numpy(kill)] = -12.0  # sigmoid ~ 6e-6

    def moments():
        return [mapper.optimizer.state[p][k] for g in mapper.optimizer.param_groups
                for p in g["params"] for k in ("exp_avg", "exp_avg_sq")]

    survivor = 1  # index 1 is not killed (kill pattern ::3)
    assert not kill[survivor]
    xyz_before = mapper.params.xyz[survivor].detach().clone()
    mom_before = [m[survivor].clone() for m in moments()]
    assert all(m.any() for m in mom_before[:2])
    reg_before = {h: mapper.registry.lookup(h)
                  for h in list(mapper.loss_anchors)[:5]
                  if mapper.registry.lookup(h) is not None}

    dropped = mapper.prune_map()
    assert dropped == int(kill.sum()), (dropped, int(kill.sum()))
    n1 = int(mapper.params.n_active)
    assert n1 == n0 - dropped

    torch.testing.assert_close(mapper.params.xyz[0].detach(), xyz_before)
    for m0, m1 in zip(mom_before, moments()):
        torch.testing.assert_close(m1[0], m0)
        assert m1.shape[0] == mapper.params.capacity

    prefix = np.concatenate([[0], np.cumsum(~kill)])
    for h, (s, c) in reg_before.items():
        r = mapper.registry.lookup(h)
        expect_c = int(prefix[s + c] - prefix[s])
        if expect_c == 0:
            assert r is None
        else:
            assert r == (int(prefix[s]), expect_c), (h, r)

    m = mapper.train_iteration()
    assert m is not None and np.isfinite(float(m.loss))
    assert mapper.prune_map() == 0


def test_concurrent_mapper_overlaps_and_converges():
    """Frames submitted from the producer thread are all mapped, the
    per-frame training credits are all spent, and the result renders keyframe
    0 above 10 dB, race-free under the lock discipline."""
    cfg = dataclasses.replace(Config(), gp=GpParams(grid=0.5))
    frames = _frames(3, 5000)
    mapper = IncrementalMapper(
        config=cfg, settings=RasterizeSettings(backend="naive"),
        bootstrap_points=200, initial_capacity=4096, device="cpu")

    cm = ConcurrentMapper(mapper, iters_per_frame=4)
    for fr in frames:
        cm.submit_frame(fr)
    mapper = cm.finish()

    assert cm.frames_mapped == 3
    assert cm.trained >= 4  # at least the post-bootstrap frames' credits
    assert cm.last_metrics is not None
    assert np.isfinite(float(cm.last_metrics.loss))
    assert cm.busy_s > 0

    out = mapper.render_keyframe(0)
    p = float(psnr(out.color, torch.from_numpy(mapper.gt_images[0])))
    assert p > 10.0, p

    # worker errors surface on finish(), not silently
    cm2 = ConcurrentMapper(mapper, iters_per_frame=1)
    cm2.submit_frame(frames[0]._replace(points_world="not an array"))
    with pytest.raises(RuntimeError):
        cm2.finish()


def test_concurrent_mapper_no_deadlock_on_worker_death():
    """A worker death with a FULL queue surfaces to the producer instead of
    deadlocking submit_frame against a queue nobody drains."""
    mapper = IncrementalMapper(settings=RasterizeSettings(backend="naive"),
                               initial_capacity=8, device="cpu")
    cm = ConcurrentMapper(mapper, iters_per_frame=1, queue_size=1)
    with pytest.raises(RuntimeError):
        for _ in range(20):
            cm.submit_frame("not a frame")
    cm._stop.set()
    cm._thread.join(timeout=5)
