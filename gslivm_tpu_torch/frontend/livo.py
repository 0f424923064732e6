"""The full LIVO front-end driver: sensors -> odometry -> VIO -> map frames
(the port's own copy of gslivm_tpu/frontend/livo.py).

ROS-free equivalent of the reference's `lioOptimization::run` + `process`
loop (lioOptimization.cpp:2289-2478, 1319-1490): consumes IMU / LiDAR /
image streams through the MeasurementSync packetizer, runs ESKF+ICP
odometry per packet, maintains the colored point map via the VIO path on
rendering packets, and emits `pipeline.Frame`s (colored world points +
posed camera) for the IncrementalMapper.

Frame conventions: odometry state (q, p) maps IMU->world. The camera sits
at R_ic/t_ic relative to the IMU (q_world_camera = q * R_ic,
lioOptimization.cpp:updateCameraParameters path).

Where the port differs from the JAX front end: its state is host numpy as
there, but each emitted Frame's `Camera` and `CameraProjection` are the
port's tensors on `device` (the mapper's device); the image path runs the
port's `vision.rgb_to_gray` and the tracker's `vision` calls in place of
OpenCV, and `image_resize_ratio != 1` and `distortion` run `imgproc`'s
bit-exact copies of cv2.resize and initUndistortRectifyMap/remap on
`device` (the image returns to the host as the uint8 numpy array cv2 would
give: the stage `intake`). `stage_seconds` accumulates the host seconds of
each stage over the packets drained since the caller last cleared it.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..config import Config
from ..models.cameras import make_camera
from ..ops.gp3d import CameraProjection
from ..pipeline import Frame
from ..utils.device import resolve_device
from . import imgproc, so3, vision
from .odometry import (
    Odometry,
    motion_compensate_constant,
    motion_compensate_imu,
)
from .sensors import ImageSample, ImuSample, LidarSweep, MeasurementSync, filter_sweep
from .vio import (
    ColorPointMap,
    OpticalFlowTracker,
    VioState,
    vio_esikf,
    vio_photometric,
)


class LivoFrontend:
    def __init__(
        self,
        config: Config = Config(),
        fx: float = 400.0, fy: float = 400.0,
        cx: float = 320.0, cy: float = 240.0,
        width: int = 640, height: int = 480,
        R_imu_lidar=np.eye(3), t_imu_lidar=np.zeros(3),
        R_imu_camera=np.eye(3), t_imu_camera=np.zeros(3),
        sweep_interval: float = 0.1,
        distortion=None,
        image_resize_ratio: float = 1.0,
        estimate_extrinsic: bool = False,
        estimate_intrinsic: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = config
        if image_resize_ratio != 1.0:
            # imageProcessing::process resize path (imageProcessing.cpp:114-127)
            fx *= image_resize_ratio
            fy *= image_resize_ratio
            cx *= image_resize_ratio
            cy *= image_resize_ratio
            width = int(width * image_resize_ratio)
            height = int(height * image_resize_ratio)
        self.image_resize_ratio = image_resize_ratio
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        self._undistort_maps = None
        if distortion is not None and np.any(np.asarray(distortion) != 0):
            # cv::initUndistortRectifyMap + remap (imageProcessing.cpp:131-135)
            xy, fxy = imgproc.undistort_rectify_map(self.K, distortion, (width, height))
            self._undistort_maps = (torch.from_numpy(xy).to(self.device),
                                    torch.from_numpy(fxy.astype(np.int32)).to(self.device))
        self.width, self.height = width, height
        self.R_ic = np.asarray(R_imu_camera, np.float64)
        self.t_ic = np.asarray(t_imu_camera, np.float64)

        self.sync = MeasurementSync(sweep_interval=sweep_interval)
        self.odometry = Odometry(config.odometry, config.icp,
                                 R_imu_lidar, t_imu_lidar)
        self.color_map = ColorPointMap(config.map)
        self.tracker = OpticalFlowTracker()
        # the tracker adds its lk / f_ransac / pnp seconds to the same dict
        self.stage_seconds: collections.defaultdict = self.tracker.seconds
        # vioEsikf extrinsic/intrinsic estimation flags: the reference
        # hardcodes both false (imageProcessing.cpp:20-21); the Jacobian
        # capability is live here behind the same gates
        self.estimate_extrinsic = estimate_extrinsic
        self.estimate_intrinsic = estimate_intrinsic
        self.vio_state = VioState(fx=fx, fy=fy, cx=cx, cy=cy,
                                  R_ic=self.R_ic.copy(),
                                  t_ic=self.t_ic.copy())
        self.frames_out: list[Frame] = []
        self._last_q = np.array([1.0, 0, 0, 0])
        self._last_p = np.zeros(3)
        self._image_index = 0  # image_filter_num decimation counter

    # ------------------------------- inputs -------------------------------

    def push_imu(self, t, gyr, acc):
        self.sync.push_imu(ImuSample(t, np.asarray(gyr), np.asarray(acc)))
        self._drain()

    def push_lidar(self, sweep: LidarSweep):
        t0 = time.perf_counter()
        self.sync.push_sweep(filter_sweep(sweep, self.cfg.common))
        self.stage_seconds["sync_imu"] += time.perf_counter() - t0
        self._drain()

    def push_image(self, t, image):
        # common/image_filter_num decimation: only every Nth image enters
        # the pipeline (imageHandler/compressedImageHandler gate,
        # lioOptimization.cpp:788,817)
        idx = self._image_index
        self._image_index += 1
        if idx % max(self.cfg.common.image_filter_num, 1) != 0:
            return
        image = np.asarray(image)
        if self.image_resize_ratio != 1.0 or self._undistort_maps is not None:
            t0 = time.perf_counter()
            img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
            if self.image_resize_ratio != 1.0:
                img = imgproc.resize_linear(img, (self.width, self.height))
            if self._undistort_maps is not None:
                img = imgproc.remap_linear(img, *self._undistort_maps)
            image = img.cpu().numpy()
            self.stage_seconds["intake"] += time.perf_counter() - t0
        self.sync.push_image(ImageSample(t, image))
        self._drain()

    # ------------------------------ pipeline ------------------------------

    def _camera_pose(self):
        """IMU pose -> world->camera extrinsics."""
        R_wi = so3.quat_to_rot(self.odometry.eskf.q)
        R_wc = R_wi @ self.R_ic
        c = R_wi @ self.t_ic + self.odometry.eskf.p
        return R_wc.T, -R_wc.T @ c, c  # R_cw, t_cw, center

    def _drain(self):
        sec = self.stage_seconds
        t0 = time.perf_counter()
        for m in self.sync.get():
            # IMU-rate propagation (run loop, 2289-2478); the state trail
            # feeds the IMU deskew path below
            self.odometry.begin_sweep_states()
            for s in m.imu:
                self.odometry.add_imu(s.t, s.gyr, s.acc)
            t1 = time.perf_counter()
            sec["sync_imu"] += t1 - t0

            # motion compensation to sweep end (buildFrame, 991-1063),
            # dispatched on odometry_options.motion_compensation exactly as
            # the reference does (lioOptimization.cpp:1006-1009)
            q1, p1 = self.odometry.eskf.q.copy(), self.odometry.eskf.p.copy()
            mc = self.cfg.odometry.motion_compensation.upper()
            if mc == "IMU" and len(self.odometry.imu_states) >= 2:
                pts = motion_compensate_imu(
                    m.points, m.rel_time, self.odometry.imu_states,
                    m.time_sweep_begin, q1, p1,
                    self.odometry.R_il, self.odometry.t_il)
            else:
                pts = motion_compensate_constant(
                    m.points, m.rel_time, self._last_q, self._last_p, q1, p1,
                    self.odometry.R_il, self.odometry.t_il,
                    duration_s=m.time_sweep_delta)
            self._last_q, self._last_p = q1, p1
            t2 = time.perf_counter()
            sec["deskew"] += t2 - t1

            res = self.odometry.add_sweep(m.time_image, pts)
            t3 = time.perf_counter()
            sec["icp"] += t3 - t2
            self.color_map.add_points(res.points_world,
                                      self.cfg.map.add_point_step)
            sec["color_map"] += time.perf_counter() - t3

            if m.rendering and m.image is not None:
                self._process_image(m, res)
            t0 = time.perf_counter()
        sec["sync_imu"] += time.perf_counter() - t0

    def _process_image(self, m, res):
        sec = self.stage_seconds
        t0 = time.perf_counter()
        R_cw, t_cw, center = self._camera_pose()
        gray = vision.rgb_to_gray(torch.from_numpy(np.ascontiguousarray(m.image)))
        t1 = time.perf_counter()
        sec["gray"] += t1 - t0

        # track + PnP gate + esikf + photometric (imageProcessing::process,
        # imageProcessing.cpp:151-194 order: trackImage -> RANSAC PnP ->
        # vioEsikf -> vioPhotometric every rendering frame); the tracker
        # times its LK, F-RANSAC and PnP itself
        if self.tracker.track(gray, m.time_image, self.color_map):
            if self.tracker.ransac_pnp(self.color_map, self.K):
                t2 = time.perf_counter()
                R_wi = so3.quat_to_rot(self.odometry.eskf.q)
                self.vio_state = vio_esikf(
                    self.vio_state, self.color_map, self.tracker.track_idx,
                    self.tracker.track_uv, R_wi, self.odometry.eskf.p,
                    number_new_voxels=max(len(self.color_map.recent_voxels), 1),
                    estimate_extrinsic=self.estimate_extrinsic,
                    estimate_intrinsic=self.estimate_intrinsic,
                )
                self.vio_state, _ = vio_photometric(
                    self.vio_state, self.color_map, self.tracker.track_idx,
                    m.image, R_wi, self.odometry.eskf.p,
                    number_new_voxels=max(len(self.color_map.recent_voxels), 1),
                    estimate_extrinsic=self.estimate_extrinsic,
                )
                if self.estimate_extrinsic:
                    # refreshed extrinsics feed the projection pose
                    self.R_ic = self.vio_state.R_ic.copy()
                    self.t_ic = self.vio_state.t_ic.copy()
                if self.estimate_intrinsic:
                    self.K = np.array([
                        [self.vio_state.fx, 0, self.vio_state.cx],
                        [0, self.vio_state.fy, self.vio_state.cy],
                        [0, 0, 1.0]])
                sec["esikf"] += time.perf_counter() - t2

        # Bayesian color rendering of recent voxels
        t3 = time.perf_counter()
        self.color_map.render_recent(m.image, R_cw, t_cw, self.K, center,
                                     m.time_image)
        t4 = time.perf_counter()
        sec["render_recent"] += t4 - t3

        # top-up the track set from the projection list
        sel, uv = self.color_map.select_points_for_projection(
            R_cw, t_cw, self.K, self.width, self.height)
        self.tracker.top_up(sel, uv)

        # emit the mapping frame (colored points = this sweep's world points)
        R_wc = R_cw.T
        camera = make_camera(R_wc, center, self.width, self.height,
                             fx=self.K[0, 0], fy=self.K[1, 1],
                             cx=self.K[0, 2], cy=self.K[1, 2], device=self.device)
        proj = CameraProjection(
            R_wc=camera.R_cw, t_wc=camera.t_cw,
            fx=camera.K[0, 0], fy=camera.K[1, 1],
            cx=camera.K[0, 2], cy=camera.K[1, 2],
            dist=torch.zeros(4, device=self.device),
        )
        self.frames_out.append(Frame(
            points_world=res.points_world,
            image=m.image,
            camera=camera,
            cam_projection=proj,
        ))
        sec["emit"] += time.perf_counter() - t4

    def pop_frames(self) -> list[Frame]:
        out = self.frames_out
        self.frames_out = []
        return out

    @property
    def pose(self):
        return self.odometry.eskf.q.copy(), self.odometry.eskf.p.copy()
