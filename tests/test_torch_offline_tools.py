"""The port's offline tools (`gslivm_tpu_torch/tools/{calib,nerf_export,
traj_plot,time_plot,see_image,sbs_video,gp_figure}.py`) against their JAX
twins in gslivm_tpu/tools/: calib to 1e-12, nerf_export's JSON equal, the
plots of traj_plot, time_plot and see_image the same files with the same
pixels (read back through the port's PNG decoder), sbs_video's frame
count, and gp_figure's `gp_forward` outputs to 1e-5 with its PNGs
written."""

import json
import os

import numpy as np
import pytest
import torch

from gslivm_tpu.tools import calib as jcalib
from gslivm_tpu.tools import gp_figure as jgp
from gslivm_tpu.tools import nerf_export as jnerf
from gslivm_tpu.tools import sbs_video as jsbs
from gslivm_tpu.tools import see_image as jsee
from gslivm_tpu.tools import time_plot as jtime
from gslivm_tpu.tools import traj_plot as jtraj
from gslivm_tpu_torch.frontend import png
from gslivm_tpu_torch.tools import (calib, gp_figure, nerf_export, sbs_video, see_image,
                                    time_plot, traj_plot)
from gslivm_tpu_torch.utils import outputs
from gslivm_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)


def _pixels(path) -> np.ndarray:
    with open(path, "rb") as f:
        return png.decode_raw(f.read())


def _same_pngs(a_paths, b_paths):
    assert [os.path.basename(p) for p in a_paths] == [os.path.basename(p) for p in b_paths]
    for a, b in zip(a_paths, b_paths):
        pa, pb = _pixels(a), _pixels(b)
        assert pa.shape == pb.shape and pa.size > 0
        np.testing.assert_array_equal(pa, pb)


def _tum(path, n=30, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i in range(n):
        outputs.append_tum_pose(str(path), 10.0 + 0.1 * i, rng.normal(size=3) + [0.1 * i, 0, 0],
                                q[i])


def test_calib_matches_jax(capsys):
    rng = np.random.default_rng(1)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(size=3)
    for a, b in ((jcalib.se3(R, t), calib.se3(R, t)), (jcalib.se3(t=t), calib.se3(t=t)),
                 (jcalib.inv_se3(jcalib.se3(R, t)), calib.inv_se3(calib.se3(R, t))),
                 (jcalib.compose_tic(jcalib.se3(R, t), jcalib.se3(R.T, -t)),
                  calib.compose_tic(calib.se3(R, t), calib.se3(R.T, -t)))):
        assert np.abs(a - b).max() <= 1e-12
    m = rng.normal(size=(4, 4))
    ja, ta = jcalib.matrix_report(m), calib.matrix_report(m)
    assert abs(ja["det"] - ta["det"]) <= 1e-12 and np.abs(ja["inv"] - ta["inv"]).max() <= 1e-12
    argv = ["--til-r", *map(str, R.ravel()), "--til-t", *map(str, t),
            "--tcl-r", *map(str, R.T.ravel()), "--tcl-t", "0.1", "0.2", "0.3"]
    jcalib.main(argv)
    want = capsys.readouterr().out
    calib.main(argv)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("invert", [False, True])
def test_nerf_export_json_equal(tmp_path, invert):
    _tum(tmp_path / "pose.txt")
    args = (str(tmp_path / "pose.txt"), 400.0, 401.0, 320.0, 240.0, 640, 480)
    a = jnerf.export_transforms(args[0], str(tmp_path / "j" / "t.json"), *args[1:], invert=invert)
    b = nerf_export.export_transforms(args[0], str(tmp_path / "t" / "t.json"), *args[1:],
                                      invert=invert)
    assert a == b and len(b["frames"]) == 30
    assert (tmp_path / "j" / "t.json").read_text() == (tmp_path / "t" / "t.json").read_text()
    assert json.loads((tmp_path / "t" / "t.json").read_text())["fl_y"] == 401.0


def test_traj_plot_same_files_and_pixels(tmp_path):
    _tum(tmp_path / "pose.txt", seed=2)
    _same_pngs(jtraj.plot_trajectory(str(tmp_path / "pose.txt"), str(tmp_path / "j")),
               traj_plot.plot_trajectory(str(tmp_path / "pose.txt"), str(tmp_path / "t")))


def test_time_plot_same_file_and_pixels(tmp_path):
    Timer.reset()
    for i in range(12):
        Timer.record("lidar_sweep", 20.0 + i, stamp=100.0 + i)
        Timer.record("optimize_vis_iter", 5.0 + 0.5 * i, stamp=100.0 + i)
    Timer.dump_into_file(12, 1500.0, str(tmp_path / "log_time.txt"))
    mem = tmp_path / "mem.csv"
    mem.write_text("".join(f"{100.0 + i},{1000 + 10 * i}\n" for i in range(12)))
    a = jtime.plot_log_time(str(tmp_path / "log_time.txt"), str(tmp_path / "j.png"), str(mem))
    b = time_plot.plot_log_time(str(tmp_path / "log_time.txt"), str(tmp_path / "t.png"), str(mem))
    np.testing.assert_array_equal(_pixels(a), _pixels(b))


@pytest.mark.parametrize("kind", ["npy", "png"])
def test_see_image_same_file_and_pixels(tmp_path, kind):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 8.0, (24, 32))
    src = tmp_path / f"depth.{kind}"
    if kind == "npy":
        np.save(src, depth)
    else:
        import cv2  # the JAX twin's reader; the port's is its own decoder

        cv2.imwrite(str(src), (depth * 30).astype(np.uint8))
        np.testing.assert_array_equal(see_image.load_depth(str(src)),
                                      jsee.load_depth(str(src)))
    import matplotlib.pyplot as plt

    jsee.main([str(src), "--out", str(tmp_path / "j.png")])
    plt.close("all")  # the JAX tool leaves its figure open
    see_image.main([str(src), "--out", str(tmp_path / "t.png"), "--device", "cpu"])
    np.testing.assert_array_equal(_pixels(tmp_path / "j.png"), _pixels(tmp_path / "t.png"))


def test_sbs_video_frame_count(tmp_path):
    rng = np.random.default_rng(4)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        for i in range(5 if d == "a" else 4):
            outputs.save_png(str(tmp_path / d / f"{i}.png"),
                             rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
    for offset in (0, 2, -1):
        j = jsbs.make_video(str(tmp_path / "a"), str(tmp_path / "b"), str(tmp_path / "j.mp4"),
                            offset=offset)
        t = sbs_video.make_video(str(tmp_path / "a"), str(tmp_path / "b"),
                                 str(tmp_path / "t.mp4"), offset=offset)
        assert t == j == (4, 3, 3)[(0, 2, -1).index(offset)]
    assert os.path.getsize(tmp_path / "t.mp4") > 0


def test_gp_figure_matches_jax_and_writes_its_pngs(tmp_path):
    from gslivm_tpu.config import GpParams as JGp
    from gslivm_tpu.ops import gp3d as jgp3d

    cfg = JGp(grid=gp_figure.GRID)
    jbatch = jgp._make_cell(np.random.default_rng(42), cfg)
    jres = jgp3d.gp_forward(jbatch, cfg)
    batch, res = gp_figure.compute(seed=42, device="cpu")
    np.testing.assert_array_equal(batch.points.numpy(), np.asarray(jbatch.points))
    for f in ("test_points", "test_var", "var_mean", "means", "covs", "update_variance"):
        a, b = np.asarray(getattr(jres, f)), getattr(res, f).numpy()
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5, f
    paths = gp_figure.main(["--out", str(tmp_path), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["gp_figure_surface.png",
                                                    "gp_figure_ellipsoids.png"]
    for p in paths:
        assert _pixels(p).shape[2] == 4
