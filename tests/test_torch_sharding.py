"""Port parity of the sharded train step on torch.distributed.

One gloo world of 4 CPU processes, spawned through the port's
multihost_demo (its own rendezvous and join timeouts), takes one step per
renderer on each mesh: (gauss 2, pixel 2), (4, 1) and (1, 4). Every rank
collects its arrays and rank 0 writes them. Each step's loss, metrics and
GRADIENT (`.grad`, the whole map gathered over "gauss") are held against
the port's single-device `train_step` from the same state, against the JAX
package's single-device naive step, and the oracle also against JAX's
`sharded_train_step` on conftest's 8-device CPU mesh (gradients read from
Adam's first moment after one step: mu = 0.1 g). Gradients, not updated
parameters: Adam's first step moves a parameter by about lr whatever the
size of its gradient, so a rule that scaled the gradient by an axis size
would pass a comparison of parameters.

The scene is tests/test_sharding.py's, seen from z = -1 so that the
capacity rows past n_active (at the origin, opacity logit -10) are in view,
with n_active 50 not a multiple of the shard size: the sharded instance
count must equal the single-device one (the JAX primitive step compares
local row indices with the global count). Two cameras form a history pair,
and simi anchors are engaged.

Tolerances, those of tests/test_sharding.py: oracle and tiles loss rtol
1e-5, gradients 1e-4 of their scale; primitive (the per-slab early stop)
loss rtol 1e-4, gradients 1e-3 of scale.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.config import GsOptimParams as JOptim
from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu.models import training as jtr
from gslivm_tpu.models.cameras import make_camera as jmake_camera
from gslivm_tpu.ops.rasterize import RasterizeSettings as JSettings
from gslivm_tpu.parallel import sharding as jsharding
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.models import training as ttr
from gslivm_tpu_torch.models.cameras import make_camera as tmake_camera
from gslivm_tpu_torch.ops.rasterize import RasterizeSettings as TSettings
from gslivm_tpu_torch.tools import multihost_demo

torch.set_num_threads(1)

W, H = 64, 48
CENTERS = ([0.0, 0.0, -1.0], [0.08, -0.04, -1.0])
FIELDS = ("xyz", "features_dc", "scaling", "rotation", "opacity")
MESHES = (2, 4, 1)  # gauss rows of a 4-rank world
RENDERERS = ("oracle", "tiles", "primitive")
TINY = "primitive:0.0625"  # a one-gaussian exchange box: overflow
BLOCK = (2, 2)
MAX_INSTANCES = 1 << 14
TOL = {"oracle": (1e-5, 1e-4), "tiles": (1e-5, 1e-4), "primitive": (1e-4, 1e-3)}
METRICS = ("loss", "image_loss", "simi", "delta", "psnr", "ssim")


def _scene():
    """tests/test_sharding.py's map (50 gaussians, capacity 64) as numpy,
    GT images and simi inputs."""
    rng = np.random.default_rng(3)
    m = 50
    batch = jgm.PointBatch(
        xyz=jnp.asarray(rng.normal(0, 1.0, (m, 3)) + [0, 0, 5.0], jnp.float32),
        rgb=jnp.asarray(rng.uniform(0, 255, (m, 3)), jnp.float32),
        cov=jnp.tile(jnp.eye(3)[None] * 0.003, (m, 1, 1)).astype(jnp.float32),
        mask=jnp.ones(m, bool))
    params = jgm.create_from_points(batch, 3.0, capacity=64)
    d = {f: np.asarray(getattr(params, f)) for f in convert.PARAM_FIELDS}
    gt = rng.uniform(size=(len(CENTERS), 3, H, W)).astype(np.float32)
    simi = {
        "points": (rng.normal(0, 1.0, (jtr.MAX_SIMI, 3)) + [0, 0, 5.0]).astype(np.float32),
        "point_mask": rng.uniform(size=jtr.MAX_SIMI) < 0.5,
        "gauss_idx": rng.integers(0, m, 2048).astype(np.int32),
        "gauss_mask": rng.uniform(size=2048) < 0.5,
    }
    return d, gt, simi


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def _tcams():
    return [tmake_camera(np.eye(3), np.asarray(c), W, H, fovx=1.0, fovy=0.8, device="cpu")
            for c in CENTERS]


def _jcams():
    return [jmake_camera(np.eye(3), np.asarray(c), W, H, fovx=1.0, fovy=0.8) for c in CENTERS]


def _port_single(d, gt, simi, settings):
    tp = convert.params_from_numpy(d, device="cpu")
    opt = ttr.make_optimizer(tp)
    m = ttr.train_step(tp, opt, _tcams(), torch.from_numpy(gt),
                       convert.simi_from_numpy(simi, device="cpu"), settings=settings,
                       n_history_pairs=1)
    return ({k: float(v) for k, v in m._asdict().items()},
            {f: _np(getattr(tp, f).grad) for f in FIELDS}, tp)


def _jax_grads(st):
    return {f: np.asarray(getattr(st.inner_states[f].inner_state[0].mu, f)) / 0.1
            for f in FIELDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d, gt, simi = _scene()
    tmp = tmp_path_factory.mktemp("sharding")
    tp = convert.params_from_numpy(d, device="cpu")
    multihost_demo.save_state(str(tmp / "state.pt"), tp, _tcams(), torch.from_numpy(gt),
                              convert.simi_from_numpy(simi, device="cpu"))
    out = tmp / "out.pt"
    # the world runs in its own processes while this one computes the references
    spawn = concurrent.futures.ThreadPoolExecutor(1).submit(multihost_demo.main, [
        "--nproc", "4", "--device", "cpu", "--gauss-axis", ",".join(map(str, MESHES)),
        "--renderer", ",".join((*RENDERERS, TINY)), "--state", str(tmp / "state.pt"),
        "--out", str(out), "--history-pairs", "1", "--block", ",".join(map(str, BLOCK)),
        "--max-instances", str(MAX_INSTANCES), "--timeout", "120"])

    naive = _port_single(d, gt, simi, TSettings(backend="naive"))
    tiles = _port_single(d, gt, simi, TSettings(backend="tiles", max_instances=MAX_INSTANCES,
                                                block_x=BLOCK[0], block_y=BLOCK[1]))
    # every capacity row active: the padding rows at the origin are in view
    all_active = dict(d, n_active=np.int32(64))
    padded = _port_single(all_active, gt, simi, TSettings(
        backend="tiles", max_instances=MAX_INSTANCES, block_x=BLOCK[0], block_y=BLOCK[1]))

    # the JAX package: its naive single-device step and its sharded oracle step
    jp = jgm.GaussianParams(**{f: jnp.asarray(v) for f, v in d.items()})
    jsimi = jtr.SimiInputs(**{k: jnp.asarray(v) for k, v in simi.items()})
    opt = jtr.make_optimizer(JOptim())
    _, st, jm = jtr.train_step(jp, opt.init(jp), _jcams(), jnp.asarray(gt), jsimi,
                               settings=JSettings(backend="naive"), n_history_pairs=1)
    mesh = jsharding.make_mesh(8, gauss_axis=2)
    sp = jsharding.shard_params(jp, mesh)
    _, sst, sm = jsharding.sharded_train_step(mesh, sp, opt.init(sp), _jcams(), jnp.asarray(gt),
                                              jsimi, renderer="oracle", n_history_pairs=1)
    assert spawn.result(timeout=300) == 0
    sharded = torch.load(out, weights_only=True)
    return {"sharded": sharded, "naive": naive, "tiles": tiles, "padded": padded,
            "jax_naive": ({k: float(getattr(jm, k)) for k in METRICS}, _jax_grads(st)),
            "jax_sharded": ({k: float(getattr(sm, k)) for k in METRICS}, _jax_grads(sst))}


def _single_for(runs, renderer):
    return runs["naive"] if renderer == "oracle" else runs["tiles"]


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("gauss", MESHES)
def test_sharded_step_matches_single_device(runs, gauss, renderer):
    got = runs["sharded"][(gauss, renderer)]
    want_m, want_g, _ = _single_for(runs, renderer)
    rtol, gtol = TOL[renderer]
    for k in METRICS:
        assert got["metrics"][k] == pytest.approx(want_m[k], rel=rtol, abs=1e-7), k
    assert want_m["delta"] > 0 and want_m["simi"] > 0  # the pair and simi engaged
    assert got["metrics"]["overflow"] == 0
    for f in FIELDS:
        g = got["grads"][f].numpy()
        # isotropic scales: the rotation has no effect and no gradient
        assert g.shape == want_g[f].shape and (f == "rotation" or np.abs(g).max() > 0), f
        assert _scaled_err(want_g[f], g) <= gtol, f
    # the JAX package's naive step, by the same gates
    jm, jg = runs["jax_naive"]
    for k in METRICS:
        assert got["metrics"][k] == pytest.approx(jm[k], rel=max(rtol, 1e-5), abs=1e-7), k
    for f in FIELDS:
        assert _scaled_err(jg[f], got["grads"][f].numpy()) <= gtol, f


@pytest.mark.parametrize("gauss", MESHES)
def test_sharded_oracle_matches_jax_sharded_step(runs, gauss):
    got = runs["sharded"][(gauss, "oracle")]
    jm, jg = runs["jax_sharded"]
    for k in METRICS:
        assert got["metrics"][k] == pytest.approx(jm[k], rel=1e-5, abs=1e-7), k
    for f in FIELDS:
        assert _scaled_err(jg[f], got["grads"][f].numpy()) <= 1e-4, f


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("gauss", MESHES)
def test_sharded_instance_count_follows_the_single_device_mask(runs, gauss, renderer):
    """The capacity rows past n_active lie at the origin, in view; a shard
    must mask them by GLOBAL row (its offset), as the single device does."""
    got = runs["sharded"][(gauss, renderer)]["metrics"]["num_instances"]
    want = _single_for(runs, renderer)[0]["num_instances"]
    if renderer != "oracle":
        assert runs["padded"][0]["num_instances"] > want  # the padding rows are in view
    assert got == want


@pytest.mark.parametrize("gauss", MESHES)
def test_tiny_exchange_budget_overflows_and_is_counted(runs, gauss):
    m = runs["sharded"][(gauss, TINY)]["metrics"]
    assert m["overflow"] > 0 and np.isfinite(m["loss"])


@pytest.mark.parametrize("gauss", MESHES)
def test_per_rank_parameter_and_adam_bytes_are_one_over_g(runs, gauss):
    param_bytes = 4 * 64 * (3 + 3 + 0 + 3 + 4 + 1)
    for renderer in RENDERERS:
        nbytes = runs["sharded"][(gauss, renderer)]["bytes"].numpy()
        assert (nbytes[:, 0] == param_bytes // gauss).all(), nbytes
        assert (nbytes[:, 1] == 2 * param_bytes // gauss).all(), nbytes


@pytest.mark.parametrize("gauss", MESHES)
def test_updated_shards_stay_equal_to_the_single_step(runs, gauss):
    """After the step the gathered shards equal the single-device step's
    parameters where the gradient is well above rounding (Adam's first
    update is about -lr * sign(g))."""
    got = runs["sharded"][(gauss, "oracle")]
    _, want_g, tp = runs["naive"]
    for f in FIELDS:
        big = np.abs(want_g[f]) > 1e-3 * np.abs(want_g[f]).max()
        np.testing.assert_allclose(got["params"][f].numpy()[big], _np(getattr(tp, f))[big],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_demo_refuses_a_missing_card_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost_demo.main(["--nproc", "2"])


def test_a_rank_that_fails_ends_the_spawn(tmp_path, capfd):
    """A rank that cannot start (here: no state file) makes the spawn return
    its exit code and kill the others, instead of leaving them waiting at
    the rendezvous."""
    rc = multihost_demo.main(["--nproc", "2", "--device", "cpu", "--state",
                              str(tmp_path / "missing.pt"), "--timeout", "20"])
    assert rc != 0
    assert "rank" in capfd.readouterr().err
