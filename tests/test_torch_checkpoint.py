"""Checkpoint / resume of the port's IncrementalMapper
(`gslivm_tpu_torch/utils/checkpoint.py`) against the JAX package's
(`gslivm_tpu/utils/checkpoint.py`), on the CPU.

Both mappers ingest the same two frames (tests/test_utils.py:83-121's
sequence), each saves and loads with its own module into a fresh mapper:
the restored states agree (parameters to 1e-5 of scale, the GP's f32
rounding as in test_torch_mapper.py; registry, colour pool and cells
equal). For one train_iteration, the JAX mapper's parameters and loss
anchors are first carried into the port's mapper (as
test_torch_mapper.py does: the GP's rounding alone moves the loss by
2.7e-5 relative here, with or without a checkpoint); then each restored
mapper draws the same cameras with metrics within rtol 1e-5. The port's
own round trip is
bit-equal, Adam's moments and steps included, with each Adam state keyed
to the restored mapper's own Parameters."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from gslivm_tpu.config import Config as JConfig
from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.frontend import synthetic as jsyn
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu.pipeline import IncrementalMapper as JMapper
from gslivm_tpu.utils import checkpoint as jckpt
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.config import Config, GpParams
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.pipeline import IncrementalMapper
from gslivm_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

METRICS = ("loss", "image_loss", "simi", "delta", "psnr", "ssim")


def _jax_mapper():
    return JMapper(config=dataclasses.replace(JConfig(), gp=JGp(grid=0.5)),
                   settings=JSettings(backend="naive"), bootstrap_points=100,
                   initial_capacity=4096)


def _port_mapper(capacity=4096):
    return IncrementalMapper(config=dataclasses.replace(Config(), gp=GpParams(grid=0.5)),
                             bootstrap_points=100, initial_capacity=capacity, device="cpu")


def _ingested_port():
    m = _port_mapper()
    for fr in synthetic.make_sequence(n_frames=2, width=48, height=36, points_per_frame=3000,
                                      device="cpu"):
        m.add_frame(fr)
    return m


def _recording_sampler(mapper):
    drawn, sample = [], mapper._sample_cameras

    def record():
        drawn.append(sample())
        return drawn[-1]

    mapper._sample_cameras = record
    return drawn


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """Restored mappers: (JAX, port, port with the JAX state carried in),
    each from its own package's checkpoint of the same ingest."""
    jm, tm = _jax_mapper(), _ingested_port()
    for fr in jsyn.make_sequence(n_frames=2, width=48, height=36, points_per_frame=3000):
        jm.add_frame(fr)
    root = tmp_path_factory.mktemp("ckpt")
    jckpt.save_mapper(jm, str(root / "jax"))
    checkpoint.save_mapper(tm, str(root / "port"))
    with torch.no_grad():
        for f in convert.PARAM_FIELDS:
            getattr(tm.params, f).copy_(torch.from_numpy(np.array(getattr(jm.params, f))))
    tm.loss_anchors = dict(jm.loss_anchors)
    checkpoint.save_mapper(tm, str(root / "carried"))
    return (jckpt.load_mapper(_jax_mapper(), str(root / "jax")),
            checkpoint.load_mapper(_port_mapper(), str(root / "port")),
            checkpoint.load_mapper(_port_mapper(), str(root / "carried")))


def test_restored_states_agree_with_jax(restored):
    jm, tm, _ = restored
    assert tm.params.capacity == jm.params.capacity
    assert int(tm.params.n_active) == int(jm.params.n_active) > 100
    for f in ("xyz", "features_dc", "rotation", "opacity", "scaling"):
        a, t = np.asarray(getattr(jm.params, f)), getattr(tm.params, f).detach().numpy()
        if f == "scaling":  # as test_torch_mapper.py: the activated scale
            assert np.abs(np.exp(a) - np.exp(t)).max() <= 1e-5
        else:
            assert np.abs(a - t).max() <= 1e-5 * np.abs(a).max(), f
    assert tm.registry._ranges == jm.registry._ranges
    assert list(tm.loss_anchors) == list(jm.loss_anchors)
    assert (tm.iter, tm.started) == (jm.iter, jm.started)
    assert tm._pending_color.keys() == jm._pending_color.keys()
    for h, (means, covs, age, mask) in jm._pending_color.items():
        t = tm._pending_color[h]
        assert age == t[2] and np.array_equal(mask, t[3])
        assert np.abs(means - t[0]).max() <= 1e-5 * max(np.abs(means).max(), 1.0)
    assert tm.gpmap.cells.keys() == jm.gpmap.cells.keys()
    for h, c in jm.gpmap.cells.items():
        d = tm.gpmap.cells[h]
        assert np.array_equal(c.ijk, d.ijk) and c.converged == d.converged
        assert np.array_equal(np.asarray(c.points), np.asarray(d.points))
        assert np.array_equal(np.asarray(c.variance), np.asarray(d.variance))
    assert tm.gpmap._pending == jm.gpmap._pending
    assert len(tm.cameras) == len(jm.cameras) == len(tm._gt_stats) == len(tm._gt_device)
    for a, b in zip(jm.cameras, tm.cameras):
        assert np.array_equal(np.asarray(a.R_cw), b.R_cw.numpy())
        assert np.array_equal(np.asarray(a.K), b.K.numpy())
    assert tm._simi_cache is None


def test_restored_mappers_take_the_same_step(restored):
    jm, _, tm = restored
    jdrawn, tdrawn = _recording_sampler(jm), _recording_sampler(tm)
    a, b = jm.train_iteration(), tm.train_iteration()
    assert tdrawn == jdrawn and len(tdrawn) == 1
    for f in METRICS:
        assert float(getattr(b, f)) == pytest.approx(float(getattr(a, f)), rel=1e-5), f


def test_port_round_trip_is_bit_equal(tmp_path):
    m = _ingested_port()
    m.train_iteration()  # live Adam moments and steps
    checkpoint.save_mapper(m, str(tmp_path))
    r = checkpoint.load_mapper(_port_mapper(capacity=1024), str(tmp_path))  # grows in place
    assert r.params.capacity == m.params.capacity
    for (name, a), b in zip(m.params.state_dict().items(), r.params.state_dict().values()):
        assert torch.equal(a, b), name
    for ga, gb in zip(m.optimizer.param_groups, r.optimizer.param_groups):
        pb = gb["params"][0]
        assert pb is getattr(r.params, gb["name"])  # Adam keyed to the mapper's Parameter
        sa, sb = m.optimizer.state[ga["params"][0]], r.optimizer.state[pb]
        assert sa.keys() == sb.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]) and sa[k].device == sb[k].device, k
    assert r.evaluate() == m.evaluate()
    assert np.isfinite(float(r.train_iteration().loss))


def test_load_normalises_tuple_registry_entries_and_refuses_a_larger_mapper(tmp_path):
    m = _ingested_port()
    checkpoint.save_mapper(m, str(tmp_path))
    host_path = os.path.join(tmp_path, checkpoint.HOST_FILE)
    with open(host_path, "rb") as f:
        host = pickle.load(f)
    # an older sidecar: one (start, count) tuple per voxel
    host["registry"] = {h: tuple(v[0]) for h, v in host["registry"].items()}
    with open(host_path, "wb") as f:
        pickle.dump(host, f)
    r = checkpoint.load_mapper(_port_mapper(), str(tmp_path))
    assert r.registry._ranges == {h: [tuple(v[0])] for h, v in m.registry._ranges.items()}
    with pytest.raises(ValueError, match="fewer than this mapper's capacity"):
        checkpoint.load_mapper(_port_mapper(capacity=8192), str(tmp_path))
