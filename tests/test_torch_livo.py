"""The LIVO front end of the port against the JAX package's, and the port's
whole stack on the CPU.

Parity: the JAX LivoFrontend and the port's take the same raw streams
(`synthetic.dolly_stream`: the e2e dolly, 96x64 images, 1,200 points a
sweep, 12 sweeps). Their odometry, colour map and frames do not depend on
the tracker (estimate_extrinsic/intrinsic are off: poses come from the
odometry alone), so frames, poses and the colour map agree to 1e-9 (they
are bit-equal). The tracker feeds `vio_state`, where the port's LK, F and
PnP RANSAC stand in for OpenCV's: measured on this stream, time_td
differs by 1.6e-7 s of 2.0e-3 s and the covariance by 1.2e-9; the test
allows 1e-5 s and 1e-6.

The stack: the port's front end -> its mapper -> the artifacts of
run_synthetic on the CPU, re-parsed by the port's offline tools."""

import os

import numpy as np
import pytest
import torch

from gslivm_tpu.config import Config as JConfig
from gslivm_tpu.config import GpParams as JGp
from gslivm_tpu.config import IcpOptions as JIcp
from gslivm_tpu.config import OdometryOptions as JOdom
from gslivm_tpu.frontend.livo import LivoFrontend as JFrontend
from gslivm_tpu_torch.config import Config, GpParams, IcpOptions, OdometryOptions
from gslivm_tpu_torch.frontend import synthetic
from gslivm_tpu_torch.frontend.livo import LivoFrontend
from gslivm_tpu_torch.pipeline import IncrementalMapper
from gslivm_tpu_torch.utils import metrics, outputs, trajectory
from gslivm_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)

W, H, POINTS = 96, 64, 1200
ODOM = dict(init_num_frames=2, voxel_size=0.05, sample_voxel_size=0.6,
            init_voxel_size=0.05, init_sample_voxel_size=0.6)
ICP = dict(min_number_neighbors=8, max_num_residuals=300, size_voxel_map=0.5, num_iters_icp=6)


def _feed(fe, stream):
    """Every sweep into the front end; the position after each."""
    for s in stream.init_imu:
        fe.push_imu(*s)
    positions = []
    for sw in stream.sweeps:
        fe.push_lidar(sw.lidar)
        for s in sw.imu:
            fe.push_imu(*s)
        fe.push_image(sw.image_time, sw.image)
        positions.append(fe.pose[1])
    return np.asarray(positions)


@pytest.fixture(scope="module")
def both():
    stream = synthetic.dolly_stream(12, W, H, POINTS)
    kw = dict(fx=stream.fx, fy=stream.fy, cx=stream.cx, cy=stream.cy, width=W, height=H)
    jfe = JFrontend(config=JConfig(gp=JGp(grid=0.5), odometry=JOdom(**ODOM), icp=JIcp(**ICP)),
                    **kw)
    tfe = LivoFrontend(config=Config(gp=GpParams(grid=0.5), odometry=OdometryOptions(**ODOM),
                                     icp=IcpOptions(**ICP)), device="cpu", **kw)
    return stream, (jfe, _feed(jfe, stream)), (tfe, _feed(tfe, stream))


def test_frames_poses_and_colour_map_match_jax(both):
    _, (jfe, jpos), (tfe, tpos) = both
    assert np.abs(tpos - jpos).max() <= 1e-9
    for a, b in zip(jfe.pose, tfe.pose):
        assert np.abs(a - b).max() <= 1e-9
    jf, tf = jfe.pop_frames(), tfe.pop_frames()
    assert len(jf) == len(tf) >= 10
    for a, b in zip(jf, tf):
        assert np.abs(a.points_world - b.points_world).max() <= 1e-9
        np.testing.assert_array_equal(a.image, b.image)
        for f in ("R_cw", "t_cw", "fx", "fy", "tan_fovx", "tan_fovy", "cam_center", "K"):
            x, y = np.asarray(getattr(a.camera, f)), getattr(b.camera, f).numpy()
            assert x.dtype == y.dtype and np.abs(x - y).max() <= 1e-9, f
        assert (a.camera.width, a.camera.height) == (b.camera.width, b.camera.height)
        for x, y in zip(a.cam_projection, b.cam_projection):
            assert np.abs(np.asarray(x) - y.numpy()).max() <= 1e-9
    jc, tc = jfe.color_map, tfe.color_map
    assert len(jc) == len(tc) > 0
    for f in ("position", "rgb", "cov_rgb", "n_rgb", "obs_distance", "last_obs_time"):
        assert np.abs(getattr(jc, f) - getattr(tc, f)).max() <= 1e-9, f
    assert jc.voxels == tc.voxels


def test_vio_state_within_the_measured_tolerance(both):
    _, (jfe, _), (tfe, _) = both
    js, ts = jfe.vio_state, tfe.vio_state
    assert abs(js.time_td - ts.time_td) <= 1e-5 and js.time_td != 0.0
    assert np.abs(js.covariance - ts.covariance).max() <= 1e-6
    for f in ("R_ic", "t_ic"):
        assert np.abs(getattr(js, f) - getattr(ts, f)).max() <= 1e-6
    assert len(tfe.tracker.track_idx) >= 8
    assert set(tfe.stage_seconds) >= {"sync_imu", "deskew", "icp", "color_map", "gray", "lk",
                                      "f_ransac", "pnp", "esikf", "render_recent", "emit"}


def test_port_stack_end_to_end_on_the_cpu(tmp_path):
    """20 sweeps of the dolly through the port's front end, every 2nd frame
    into the port's mapper, 4 train iterations (~2.4 s each on one core),
    then run_synthetic's artifacts: ATE under the e2e floor (0.05 m), and
    the TUM files, the renders and log_time.txt re-parse through the port's
    tools."""
    Timer.reset()
    out = str(tmp_path)
    stream = synthetic.dolly_stream(20, W, H, POINTS, seed=3)
    cfg = Config(gp=GpParams(grid=0.5), odometry=OdometryOptions(**ODOM), icp=IcpOptions(**ICP))
    fe = LivoFrontend(config=cfg, fx=stream.fx, fy=stream.fy, cx=stream.cx, cy=stream.cy,
                      width=W, height=H, device="cpu")
    for s in stream.init_imu:
        fe.push_imu(*s)
    est = []
    for sw in stream.sweeps:
        with Timer.evaluate("frontend_sweep"):
            fe.push_lidar(sw.lidar)
            for s in sw.imu:
                fe.push_imu(*s)
            fe.push_image(sw.image_time, sw.image)
        q, p = fe.pose
        est.append(p)
        outputs.append_tum_pose(os.path.join(out, "pose.txt"), sw.t_end, p,
                                [q[1], q[2], q[3], q[0]])
        outputs.append_tum_pose(os.path.join(out, "pose_gt.txt"), sw.t_end,
                                sw.gt_displacement, [0, 0, 0, 1])
    gt = np.asarray([sw.gt_displacement for sw in stream.sweeps])
    ate = float(np.sqrt(np.mean(np.sum((np.asarray(est) - gt) ** 2, axis=1))))
    assert ate < 0.05, ate

    mapper = IncrementalMapper(config=cfg, bootstrap_points=200, initial_capacity=4096,
                               device="cpu")
    frames = fe.pop_frames()
    assert len(frames) >= 15
    for fr in frames[::2]:
        with Timer.evaluate("gsPointCloudUpdate"):
            mapper.add_frame(fr)
    assert mapper.started
    for _ in range(4):
        with Timer.evaluate("optimize_vis_iter"):
            m = mapper.train_iteration()
    assert np.isfinite(float(m.loss)) and int(m.overflow) == 0

    os.makedirs(os.path.join(out, "training"))
    kf = [0, len(mapper.cameras) - 1]
    for i in kf:
        outputs.save_side_by_side(os.path.join(out, "training", f"{i}.png"),
                                  mapper.render_keyframe(i).color.numpy(), mapper.gt_images[i])
    mapper.save_ply(os.path.join(out, "map.ply"))
    Timer.dump_into_file(len(mapper.cameras), 20 * 100.0, os.path.join(out, "log_time.txt"))
    Timer.reset()

    ev = metrics.evaluate_dir(os.path.join(out, "training"), device="cpu")
    assert ev["count"] == len(kf) and np.isfinite(ev["mean_psnr"])
    lt = metrics.parse_log_time(os.path.join(out, "log_time.txt"))
    assert len(lt["sections"]["frontend_sweep"]) == 20
    assert len(lt["sections"]["optimize_vis_iter"]) == 4
    res = trajectory.evaluate_tum_files(os.path.join(out, "pose.txt"),
                                        os.path.join(out, "pose_gt.txt"))
    assert res["matched"] == 20 and res["ate_rmse"] <= ate + 1e-9
    assert os.path.getsize(os.path.join(out, "map.ply")) > 1000
