"""The captured training step's rules on the CPU (`training.StepGraph`,
`training.step_key`, `IncrementalMapper.train_iteration`): the CPU mapper
never captures and trains exactly as the eager step; the step's key
changes with each of its fields and with nothing else; and, with a
stand-in graph (the capture runs its body, a replay launches nothing), the
mapper's eager / capture / replay sequence across re-keys, its counters,
the launch counters' accounting and the replayed `.grad`. The capture
itself runs only on the card (tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch

from gslivm_tpu_torch.config import Config, GpParams
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.models import gaussian_model as gm
from gslivm_tpu_torch.models import training
from gslivm_tpu_torch.models.cameras import make_camera
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings
from gslivm_tpu_torch.pipeline import IncrementalMapper

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    return synthetic.make_sequence(3, 32, 32, points_per_frame=1000, device="cpu")


def _mapper(frames):
    cfg = dataclasses.replace(Config(), gp=GpParams(
        grid=0.5, image_sliding_window=1, curr_cam_per_iter=1, history_cam_per_iter=1))
    m = IncrementalMapper(cfg, settings=RasterizeSettings(backend="tiles", max_instances=4096,
                                                          max_chunks_per_tile=4),
                          bootstrap_points=200, initial_capacity=4096, device="cpu")
    for f in frames:
        m.add_frame(f)
    return m


def _eager_iteration(m):
    """train_iteration as it was before the step was captured."""
    curr, pairs = m._sample_cameras()
    idx = curr + [i for pr in pairs for i in pr]
    metrics = training.train_step(
        m.params, m.optimizer, [m.cameras[i] for i in idx],
        torch.stack([m._gt_device[i] for i in idx]), m._simi_inputs(), opt_params=m.cfg.gs,
        settings=m.settings, n_history_pairs=len(pairs), bg_color=m._bg,
        gt_stats=(torch.stack([m._gt_stats[i][0] for i in idx]),
                  torch.stack([m._gt_stats[i][1] for i in idx])))
    m.iter += 1
    m._read_feedback(metrics)
    return metrics


def test_cpu_mapper_never_captures_and_trains_as_the_eager_step(frames):
    a, b = _mapper(frames), _mapper(frames)
    for _ in range(2):
        got, want = a.train_iteration(), _eager_iteration(b)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (a.eager_steps, a.graph_captures, a.graph_replays) == (2, 0, 0)
    assert all(torch.equal(p, q) for p, q in zip(a.params.parameters(), b.params.parameters()))


def _key_args():
    params = gm.create_empty(64, device="cpu")
    cams = [make_camera(torch.eye(3).numpy(), [0.0, 0.0, float(i)], 48, 32, fovx=1.0,
                        fovy=0.8, device="cpu") for i in range(3)]
    return dict(params=params, cameras=cams, n_history_pairs=1,
                simi=training.empty_simi(device="cpu"), with_stats=True,
                opt_params=Config().gs, settings=RasterizeSettings(),
                bg_color=torch.ones(3))


def _resized(cams, w, h):
    return [dataclasses.replace(c, width=w, height=h) for c in cams]


def _regrown(params):
    gm.grow_capacity(params, 2 * params.capacity)
    return params


def _restored(params):
    params.xyz.data = params.xyz.data.clone()
    return params


def _in_place(params):
    with torch.no_grad():
        params.xyz += 1.0
    params.n_active.fill_(7)
    return params


# each change: (the argument, its new value from the old, whether the key moves)
CHANGES = {
    "capacity": ("params", _regrown, True),
    "parameter_storage": ("params", _restored, True),
    "max_instances": ("settings", lambda s: s._replace(max_instances=2**19), True),
    "max_chunks_per_tile": ("settings", lambda s: s._replace(max_chunks_per_tile=32), True),
    "camera_count": ("cameras", lambda c: c[:2], True),
    "n_history_pairs": ("n_history_pairs", lambda n: 0, True),
    "height": ("cameras", lambda c: _resized(c, 48, 48), True),
    "width": ("cameras", lambda c: _resized(c, 64, 32), True),
    "gt_stats": ("with_stats", lambda s: False, True),
    "parameter_values": ("params", _in_place, False),
    "camera_poses": ("cameras", lambda c: [make_camera(
        torch.eye(3).numpy(), [1.0, 2.0, 3.0], 48, 32, fovx=0.9, fovy=0.7, device="cpu")
        for _ in c], False),
    "simi_values": ("simi", lambda s: training.SimiInputs(
        s.points + 1.0, ~s.point_mask, s.gauss_idx + 1, ~s.gauss_mask), False),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_step_key_changes_with_each_of_its_fields(change):
    args = _key_args()
    before = training.step_key(**args)
    assert training.step_key(**args) == before
    name, fn, moves = CHANGES[change]
    args[name] = fn(args[name])
    assert (training.step_key(**args) != before) == moves


class _StandInGraph:
    """torch.cuda.CUDAGraph on the CPU: the capture runs its body once (as
    if it launched one K1, K2 and K3), a replay launches nothing."""

    replays = 0

    def replay(self):
        _StandInGraph.replays += 1


class _stand_in_capture:
    def __init__(self, graph, **kw):
        assert kw == {"capture_error_mode": "thread_local"}

    def __enter__(self):
        for c in training._launch_counters():
            c.launches += 1

    def __exit__(self, *exc):
        return False


def test_mapper_rekeys_and_replays_with_a_stand_in_graph(frames, monkeypatch):
    monkeypatch.setattr(training, "graphable", lambda params, settings: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stand_in_capture)
    monkeypatch.setattr(_StandInGraph, "replays", 0)
    m = _mapper(frames)
    counters = training._launch_counters()
    for c in counters:  # the stand-in's launches leave no count behind
        monkeypatch.setattr(c, "launches", c.launches)
    launches = [c.launches for c in counters]
    modes, metrics = [], []

    def iteration():
        counts = (m.eager_steps, m.graph_captures, m.graph_replays)
        metrics.append(m.train_iteration())
        step = (m.eager_steps - counts[0], m.graph_captures - counts[1],
                m.graph_replays - counts[2])
        modes.append({(1, 0, 0): "eager", (0, 1, 1): "capture", (0, 0, 1): "replay"}[step])

    for _ in range(3):
        iteration()
    # each replay counts the launches the capture recorded; the capture none
    assert [c.launches - b for c, b in zip(counters, launches)] == [2, 2, 2]
    assert _StandInGraph.replays == 2
    static = m._graph._grads
    assert all(p.grad is g for p, g in zip(m.params.parameters(), static))
    m.settings = m.settings._replace(max_chunks_per_tile=8)   # a new key
    iteration()
    assert m._graph.graph is None and m._graph.inputs is None
    iteration()
    n0 = int(m.params.n_active)
    cut = float(m.params.get_opacity().detach()[:n0, 0].quantile(0.1))
    assert m.prune_map(min_opacity=cut) > 0   # compaction: new storage
    iteration()
    iteration()
    assert modes == ["eager", "capture", "replay", "eager", "capture", "eager", "capture"]
    assert (m.eager_steps, m.graph_captures, m.graph_replays) == (3, 3, 4)
    ptrs = [t.data_ptr() for mt in metrics for t in mt]
    assert len(set(ptrs)) == len(ptrs)
    assert all(torch.isfinite(mt.loss) for mt in metrics)
