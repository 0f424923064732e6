"""Port parity of map growth: appending GP batches, capacity growth,
pruning and compaction, the voxel-hash registry, the Adam state carried
across growth and compaction, and smooth_depth, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gslivm_tpu.models import gaussian_model as jgm
from gslivm_tpu.models import training as jtr
from gslivm_tpu.ops import losses as jlosses
from gslivm_tpu_torch import convert
from gslivm_tpu_torch.models import gaussian_model as tgm
from gslivm_tpu_torch.models import training as ttr
from gslivm_tpu_torch.models.cameras import make_camera
from gslivm_tpu_torch.ops import losses as tlosses

torch.set_num_threads(1)

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
# computed through log/sqrt (scaling) and rgb_to_sh (features_dc): the two
# packages' f32 transcendentals may round apart by an ulp
ROUNDED = {"scaling": 1e-6, "features_dc": 1e-6}


def _batch(rng, m, valid=0.7):
    """A seeded PointBatch as numpy: centres, uint8-valued colours, SPD
    covariances, about `valid` of the rows masked in."""
    a = rng.normal(0, 0.05, (m, 3, 3))
    return {"xyz": rng.normal(0, 2.0, (m, 3)).astype(np.float32),
            "rgb": rng.integers(0, 256, (m, 3)).astype(np.float32),
            "cov": (a @ a.transpose(0, 2, 1) + 1e-6 * np.eye(3)).astype(np.float32),
            "mask": rng.uniform(size=m) < valid}


def _jbatch(d):
    return jgm.PointBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def _tbatch(d):
    return tgm.PointBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()})


def _assert_params_equal(jp, tp):
    assert tp.capacity == jp.capacity
    assert int(tp.n_active) == int(jp.n_active)
    for f in FIELDS:
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).detach().numpy()
        assert a.shape == b.shape, f
        if f in ROUNDED:
            np.testing.assert_allclose(b, a, rtol=0, atol=ROUNDED[f], err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_append_points_with_masked_and_overflowing_rows():
    rng = np.random.default_rng(0)
    jp, tp = jgm.create_empty(16), tgm.create_empty(16, device="cpu")
    for m in (9, 20):  # the second batch's valid rows overflow the capacity
        b = _batch(rng, m)
        jp = jgm.append_points(jp, _jbatch(b), 3.0)
        assert tgm.append_points(tp, _tbatch(b), 3.0) is tp
        _assert_params_equal(jp, tp)
    assert int(tp.n_active) == 16
    # create_from_points: a fresh model from one batch
    b = _batch(rng, 10)
    _assert_params_equal(jgm.create_from_points(_jbatch(b), 3.0, 12),
                         tgm.create_from_points(_tbatch(b), 3.0, 12))


def test_grow_and_ensure_capacity():
    rng = np.random.default_rng(1)
    b = _batch(rng, 10, valid=1.0)
    jp = jgm.append_points(jgm.create_empty(8), _jbatch(b), 3.0)
    tp = tgm.append_points(tgm.create_empty(8, device="cpu"), _tbatch(b), 3.0)
    _assert_params_equal(jp, tp)
    ids = {f: id(getattr(tp, f)) for f in FIELDS}
    jp = jgm.ensure_capacity(jp, 20)      # 8 live + 20 -> 32 by doubling
    assert tgm.ensure_capacity(tp, 20) is tp
    _assert_params_equal(jp, tp)
    assert tp.capacity == 32
    # in place: the module holds the same Parameter objects
    assert {f: id(getattr(tp, f)) for f in FIELDS} == ids
    jp = jgm.grow_capacity(jp, 40)
    tgm.grow_capacity(tp, 40)
    _assert_params_equal(jp, tp)
    tgm.ensure_capacity(tp, 2)            # fits: no growth
    assert tp.capacity == 40


def test_ensure_capacity_refuses_past_2_24(monkeypatch):
    """The gaussian ids ride as exact f32 through the tile kernels: the
    growth stops at 2^24. Checked on the arithmetic, with an 8-row map
    whose n_active says it is nearly full."""
    tp = tgm.create_empty(8, device="cpu")
    tp.n_active.fill_(2**24 - 4)
    asked = []
    monkeypatch.setattr(tgm, "grow_capacity", lambda p, c: asked.append(c) or p)
    tgm.ensure_capacity(tp, 4)            # exactly 2^24: allowed
    assert asked == [2**24] == [tgm.MAX_CAPACITY]
    with pytest.raises(ValueError, match="2\\^24"):
        tgm.ensure_capacity(tp, 5)
    assert asked == [2**24]


def _filled(rng, cap=24, n=20):
    b = _batch(rng, n, valid=1.0)
    jp = jgm.append_points(jgm.create_empty(cap), _jbatch(b), 3.0)
    tp = tgm.append_points(tgm.create_empty(cap, device="cpu"), _tbatch(b), 3.0)
    op = rng.normal(0, 3.0, (cap, 1)).astype(np.float32)
    jp = jp.replace(opacity=jnp.asarray(op))
    with torch.no_grad():
        tp.opacity.copy_(torch.from_numpy(op))
    return jp, tp


def test_prune_permutation_compact_and_prune_low_opacity():
    rng = np.random.default_rng(2)
    jp, tp = _filled(rng)
    keep = rng.uniform(size=jp.capacity) < 0.6
    jo, jc = jgm.prune_permutation(jp, jnp.asarray(keep))
    to, tc = tgm.prune_permutation(tp, torch.from_numpy(keep))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert int(tc) == int(jc)
    _assert_params_equal(jgm.compact(jp, jo, jc), tgm.compact(tp, to, tc))
    # rows past the count are ZEROED, opacity and scaling included
    assert not tp.opacity[int(tc):].any() and not tp.scaling[int(tc):].any()

    jp, tp = _filled(rng)
    jp = jgm.prune_low_opacity(jp, 0.3)
    tgm.prune_low_opacity(tp, 0.3)
    _assert_params_equal(jp, tp)
    assert 0 < int(tp.n_active) < 20


def test_registry_sequence_matches():
    rng = np.random.default_rng(3)
    jr, tr = jgm.HashIndexRegistry(), tgm.HashIndexRegistry()
    start = 0
    for step in range(30):
        h, c = int(rng.integers(-50, 50)), int(rng.integers(1, 6))
        assert jr.insert(h, start, c) == tr.insert(h, start, c)
        if step % 4 == 0:
            jr.append_range(h + 1, start, c)
            tr.append_range(h + 1, start, c)
        start += c
    assert tr._ranges == jr._ranges and len(tr) == len(jr)
    keep = rng.uniform(size=start) < 0.5
    keep[:3] = False
    jr.remap_pruned(keep)
    tr.remap_pruned(keep)
    assert tr._ranges == jr._ranges
    hashes = list(jr._ranges)[:7]
    np.testing.assert_array_equal(tr.indices_for(hashes), jr.indices_for(hashes))
    for h in range(-52, 52):
        assert tr.lookup(h) == jr.lookup(h) and tr.ranges(h) == jr.ranges(h)
    assert convert.registry_from_ranges(jr._ranges)._ranges == jr._ranges


def _optax_state(jp, rng):
    """The JAX optimizer's state over jp with random moments and count 3 in
    every group (as if three steps had run)."""
    st = jtr.make_optimizer(jtr.GsOptimParams()).init(jp)
    cap = jp.capacity

    def fill(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == cap:
            return jnp.asarray(rng.uniform(0.1, 1.0, leaf.shape).astype(np.float32))
        if hasattr(leaf, "dtype") and leaf.ndim == 0 and leaf.dtype == jnp.int32:
            return jnp.asarray(3, jnp.int32)
        return leaf

    return jax.tree.map(fill, st)


def _carry(st):
    """opt_state.inner_states[name].inner_state[0] -> {mu, nu, count} per group."""
    out = {}
    for f in FIELDS:
        s = st.inner_states[f].inner_state[0]
        out[f] = {"mu": np.asarray(getattr(s.mu, f)), "nu": np.asarray(getattr(s.nu, f)),
                  "count": np.asarray(s.count)}
    return out


def _assert_moments_equal(st, opt, tp):
    d = _carry(st)
    for g in opt.param_groups:
        (p,) = g["params"]
        assert p is getattr(tp, g["name"])
        s = opt.state[p]
        np.testing.assert_array_equal(s["exp_avg"].numpy(), d[g["name"]]["mu"])
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), d[g["name"]]["nu"])
        assert float(s["step"]) == float(d[g["name"]]["count"]) == 3.0
        assert s["exp_avg"].shape == p.shape


def test_adam_state_follows_growth_and_compaction():
    rng = np.random.default_rng(4)
    jp, tp = _filled(rng, cap=16, n=12)
    st = _optax_state(jp, rng)
    opt = ttr.make_optimizer(tp)
    convert.adam_state_from_numpy(opt, tp, _carry(st))
    _assert_moments_equal(st, opt, tp)

    st = jtr.grow_opt_state(st, 16, 32)
    tgm.grow_capacity(tp, 32)
    ttr.grow_opt_state(opt, 16, 32)
    _assert_moments_equal(st, opt, tp)
    assert not opt.state[tp.xyz]["exp_avg"][16:].any()

    keep = rng.uniform(size=32) < 0.5
    jo, jc = jgm.prune_permutation(jgm.grow_capacity(jp, 32), jnp.asarray(keep))
    st = jtr.compact_opt_state(st, jo, jc)
    to, tc = tgm.prune_permutation(tp, torch.from_numpy(keep))
    tgm.compact(tp, to, tc)
    ttr.compact_opt_state(opt, to, tc)
    _assert_moments_equal(st, opt, tp)
    assert not opt.state[tp.opacity]["exp_avg_sq"][int(tc):].any()


def test_train_step_after_in_place_growth_trains_the_grown_rows():
    """Growth keeps the Parameter objects, so the optimizer still steps the
    module's own tensors, and rows appended after the growth train."""
    rng = np.random.default_rng(5)
    w, h = 32, 24
    cam = make_camera(np.eye(3), np.zeros(3), w, h, fovx=1.0, fovy=0.8, device="cpu")

    def batch(n):
        b = _batch(rng, n, valid=1.0)
        b["xyz"] = (rng.normal(0, 0.6, (n, 3)) + [0, 0, 4.0]).astype(np.float32)
        b["cov"] = np.tile(np.eye(3, dtype=np.float32) * 0.004, (n, 1, 1))
        return _tbatch(b)

    tp = tgm.create_from_points(batch(30), 3.0, 32)
    opt = ttr.make_optimizer(tp)
    gt = torch.rand(1, 3, h, w, generator=torch.Generator().manual_seed(0))
    simi = ttr.empty_simi(max_gauss=16, device="cpu")
    ttr.train_step(tp, opt, [cam], gt, simi)
    tgm.ensure_capacity(tp, 20)
    ttr.grow_opt_state(opt, 32, tp.capacity)
    tgm.append_points(tp, batch(20), 3.0)
    assert tp.capacity == 64 and int(tp.n_active) == 50
    before = tp.features_dc.detach().clone()
    ttr.train_step(tp, opt, [cam], gt, simi)
    moved = (tp.features_dc.detach() != before).any(dim=(1, 2))
    assert moved[30:50].any() and not moved[50:].any()
    for g in opt.param_groups:
        (p,) = g["params"]
        assert p is getattr(tp, g["name"])
        assert opt.state[p]["exp_avg"].shape[0] == tp.capacity
        assert float(opt.state[p]["step"]) == 2.0


def test_smooth_depth_matches():
    """The same 3x3 window, as one separable blur against JAX's 2-D
    convolution: sums in another order, so 1e-6 of the depth scale."""
    rng = np.random.default_rng(6)
    for h, w in ((17, 23), (48, 64)):
        d = rng.uniform(0.5, 6.0, (h, w)).astype(np.float32)
        d[rng.uniform(size=(h, w)) < 0.1] = 0.0
        jv = float(jlosses.smooth_depth(jnp.asarray(d)))
        tv = float(tlosses.smooth_depth(torch.from_numpy(d)))
        assert tv == pytest.approx(jv, rel=1e-6, abs=1e-6 * float(d.max()))
