"""The port's utils against the JAX package's: the Timer's log_time.txt
dump and its parser, the PNG / PCD / TUM / cfg_args writers (byte-equal
files), trajectory metrics, debug dumps (tensors and arrays) and the stall
watchdog, plus the port's torch-side device_memory_mb and DeviceTrace on
the CPU."""

import os

import numpy as np
import pytest
import torch

from gslivm_tpu.utils import debug as jdebug
from gslivm_tpu.utils import metrics as jmetrics
from gslivm_tpu.utils import outputs as joutputs
from gslivm_tpu.utils import trajectory as jtraj
from gslivm_tpu.utils import watchdog as jwatchdog
from gslivm_tpu.utils.timer import Timer as JTimer
from gslivm_tpu_torch.utils import debug, metrics, outputs, timer, trajectory, watchdog

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_timer_dump_and_parse_match_jax(tmp_path):
    records = {"frontend_sweep": [(12.5, 100.0), (13.25, 100.1)],
               "optimize_vis_iter": [(3.0, 100.2)]}
    for T in (JTimer, timer.Timer):
        T.reset()
        for name, rec in records.items():
            for ms, stamp in rec:
                T.record(name, ms, stamp)
        with T.evaluate("gsPointCloudUpdate", stamp=101.0):
            pass
    paths = [str(tmp_path / f"log_{i}.txt") for i in range(2)]
    JTimer.dump_into_file(4, 1000.0, paths[0])
    timer.Timer.dump_into_file(4, 1000.0, paths[1])
    jp, tp = jmetrics.parse_log_time(paths[0]), metrics.parse_log_time(paths[1])
    assert tp["realtime_ms"] == jp["realtime_ms"] == 250.0
    assert list(tp["sections"]) == list(jp["sections"])
    for name in records:
        assert tp["sections"][name] == jp["sections"][name]
    assert metrics.parse_log_time(paths[0]) == jp  # the port's parser reads JAX dumps
    assert timer.Timer.summary()["frontend_sweep"]["calls"] == 2
    for T in (JTimer, timer.Timer):
        T.reset()


def test_writers_are_byte_equal(tmp_path, rng):
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    render, gt = rng.uniform(0, 1, (3, 12, 16)), rng.uniform(0, 1, (3, 12, 16))
    depth = rng.uniform(1, 5, (12, 16))
    for mod, d in ((joutputs, "j"), (outputs, "t")):
        out = tmp_path / d
        out.mkdir()
        mod.save_pcd_rgb(str(out / "map.pcd"), pts, cols)
        mod.save_side_by_side(str(out / "sbs.png"), render, gt)
        mod.save_depth_sbs(str(out / "depth.png"), depth, depth * 1.1)
        for k in range(3):
            mod.append_tum_pose(str(out / "pose.txt"), 0.1 * k, [k, 2.0 * k, 0.5],
                                [0, 0, 0, 1])
            mod.append_vec3(str(out / "vel.txt"), 0.1 * k, [k, 1.0, -k])
        mod.write_cfg_args(str(out), 0, True)
    for name in ("map.pcd", "sbs.png", "depth.png", "pose.txt", "vel.txt", "cfg_args"):
        a, b = _bytes(tmp_path / "j" / name), _bytes(tmp_path / "t" / name)
        if name == "cfg_args":  # names its own directory
            a = a.replace(str(tmp_path / "j").encode(), b"")
            b = b.replace(str(tmp_path / "t").encode(), b"")
        assert a == b, name
    p, c = outputs.load_pcd_rgb(str(tmp_path / "t" / "map.pcd"))
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(c, cols)


def test_trajectory_metrics_match_jax(tmp_path, rng):
    gt = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    est = gt @ np.array([[0.99, -0.1, 0], [0.1, 0.99, 0], [0, 0, 1.0]]).T + [0.2, 0, 0.1]
    est += rng.normal(0, 0.01, est.shape)
    for align in (True, False):
        assert trajectory.ate_rmse(est, gt, align) == jtraj.ate_rmse(est, gt, align)
    assert trajectory.rpe_rmse(est, gt, 2) == jtraj.rpe_rmse(est, gt, 2)
    for i in range(40):
        outputs.append_tum_pose(str(tmp_path / "e.txt"), 0.1 * i, est[i], [0, 0, 0, 1])
        outputs.append_tum_pose(str(tmp_path / "g.txt"), 0.1 * i + 0.001, gt[i], [0, 0, 0, 1])
    a = trajectory.evaluate_tum_files(str(tmp_path / "e.txt"), str(tmp_path / "g.txt"))
    b = jtraj.evaluate_tum_files(str(tmp_path / "e.txt"), str(tmp_path / "g.txt"))
    assert a == b and a["matched"] == 40


def test_debug_dumps_take_tensors_and_arrays(tmp_path, rng):
    x = rng.normal(size=(4, 5)).astype(np.float32)
    debug.save_tensor(str(tmp_path / "t.npy"), torch.from_numpy(x).requires_grad_(True))
    jdebug.save_tensor(str(tmp_path / "j.npy"), x)
    np.testing.assert_array_equal(debug.load_tensor(str(tmp_path / "t.npy")), x)
    assert debug.compare_dumps(str(tmp_path / "t.npy"), str(tmp_path / "j.npy")) == \
        jdebug.compare_dumps(str(tmp_path / "t.npy"), str(tmp_path / "j.npy"))
    debug.save_tensor(str(tmp_path / "y.npy"), x * 1.001)
    assert not debug.compare_dumps(str(tmp_path / "t.npy"), str(tmp_path / "y.npy"))["match"]


def test_watchdog_matches_jax():
    calls = {"t": 0, "j": 0}
    dogs = {"t": watchdog.StallWatchdog(on_stall=lambda: calls.__setitem__("t", calls["t"] + 1)),
            "j": jwatchdog.StallWatchdog(on_stall=lambda: calls.__setitem__("j", calls["j"] + 1))}
    for k, d in dogs.items():
        d.notify_data()
        assert not d.check()  # not started yet
        d.notify_started()
        d.notify_data()
        assert not d.check()  # data arrived since the last tick
        assert d.check() and d.check()  # stalled: stop, once
    assert calls == {"t": 1, "j": 1}


def test_device_memory_and_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timer.device_memory_mb() == {}
    with timer.DeviceTrace(str(tmp_path / "trace")) as tr:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("mm" in e.key for e in tr.profile.key_averages())


@pytest.mark.parametrize("mod", [outputs, joutputs], ids=["port", "jax"])
def test_jet_colormap_endpoints(mod):
    v = mod.jet_colormap(np.array([0.0, 0.5, 1.0]))
    assert v.dtype == np.uint8 and v.shape == (3, 3)
    np.testing.assert_array_equal(outputs.jet_colormap(np.linspace(0, 1, 7)),
                                  joutputs.jet_colormap(np.linspace(0, 1, 7)))
