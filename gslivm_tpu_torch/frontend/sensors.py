"""Sensor ingestion: LiDAR decoders, stream buffers, measurement sync.
(the port's own copy of gslivm_tpu/frontend/sensors.py; numpy on the host, as there)

Behavioral spec: reference `src/liw/cloudProcessing.cpp` (per-vendor ROS
decoders -> point3D stream) and `lioOptimization::getMeasurements`
(lioOptimization.cpp:852-958, the packetizer that slices point/imu streams
at image timestamps or the sweep interval, tagging packets rendering=True
iff they end at an image).

ROS-free redesign: sensors produce neutral numpy records —

  LidarSweep: xyz [N,3] in the sensor frame, per-point relative time [N]
  (seconds from sweep begin), intensity [N]; ImuSample: (t, gyr, acc);
  ImageSample: (t, rgb image).

The per-vendor quirks of cloudProcessing.cpp are applied by
`filter_sweep` (Livox tag filtering is assumed done by the producer):
blind-range cull (cloudProcessing.cpp:119-157), det_range cull,
point_filter_num decimation, and time-sorting with the Velodyne >0.1 s
clip (cloudProcessing.cpp:159-213).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple

import numpy as np

from ..config import CommonOptions


class LidarSweep(NamedTuple):
    t_begin: float
    xyz: np.ndarray        # [N, 3] sensor frame
    rel_time: np.ndarray   # [N] seconds from t_begin
    intensity: np.ndarray  # [N]


class ImuSample(NamedTuple):
    t: float
    gyr: np.ndarray
    acc: np.ndarray


class ImageSample(NamedTuple):
    t: float
    image: np.ndarray  # [H, W, 3] RGB uint8


def filter_sweep(sweep: LidarSweep, opts: CommonOptions = CommonOptions(),
                 lidar_type: str | None = None, max_rel_time: float = 0.1
                 ) -> LidarSweep:
    """Per-vendor sweep normalization + filters (cloudProcessing.cpp):

      livox    : decimate -> range cull                          (:119-157)
      velodyne : time-sort -> clip rel>=0.1s -> decimate -> cull (:159-213)
      ouster   : decimate -> cull (no sort/clip)                 (:215-257)
      robosense: time-sort -> clip -> cull, NO decimation quirk
                 (the handler loop omits the i%point_filter_num
                 test)                                           (:259-311)
      pandar   : time-sort -> clip -> decimate -> cull           (:313-368)

    Decimation keeps RAW indices i % point_filter_num == 0 BEFORE the range
    cull (the reference's loop order — a culled point still advances i).
    The per-vendor time-UNIT normalization (Ouster ns, Robosense/Pandar
    absolute stamps) happens at decode (rosbag.decode_pointcloud2);
    rel_time here is always seconds from t_begin."""
    lt = lidar_type if lidar_type is not None else opts.lidar_type
    xyz, rel, inten = sweep.xyz, sweep.rel_time, sweep.intensity
    if lt in ("velodyne", "robosense", "pandar") and rel.size:
        order = np.argsort(rel, kind="stable")
        xyz, rel, inten = xyz[order], rel[order], inten[order]
        clip = rel < max_rel_time  # pop-while >= 0.1 (cloudProcessing:176)
        xyz, rel, inten = xyz[clip], rel[clip], inten[clip]
    if lt != "robosense":
        idx = np.arange(xyz.shape[0])[:: max(opts.point_filter_num, 1)]
        xyz, rel, inten = xyz[idx], rel[idx], inten[idx]
    r = np.linalg.norm(xyz, axis=1)
    keep = (r > opts.blind) & (r < opts.det_range)
    keep &= np.isfinite(xyz).all(axis=1)
    return LidarSweep(sweep.t_begin, xyz[keep], rel[keep], inten[keep])


class Measurement(NamedTuple):
    """One synchronized packet (Measurements, lioOptimization.h)."""

    time_sweep_begin: float
    time_sweep_delta: float
    time_image: float
    points: np.ndarray      # [N, 3] sensor frame
    rel_time: np.ndarray    # [N]
    imu: list[ImuSample]
    image: np.ndarray | None
    rendering: bool


@dataclasses.dataclass
class MeasurementSync:
    """getMeasurements (lioOptimization.cpp:852-958) as an incremental
    packetizer over neutral sensor streams."""

    sweep_interval: float = 0.1

    def __post_init__(self):
        self.points: deque = deque()      # (t_abs, xyz, rel)
        self.imu: deque = deque()         # ImuSample
        self.images: deque = deque()      # ImageSample
        self.last_get = -1.0

    def push_sweep(self, sweep: LidarSweep):
        for p, rt in zip(sweep.xyz, sweep.rel_time):
            self.points.append((sweep.t_begin + rt, p, rt))

    def push_imu(self, s: ImuSample):
        self.imu.append(s)

    def push_image(self, s: ImageSample):
        self.images.append(s)

    def _emit(self, t_end: float, image: np.ndarray | None,
              rendering: bool) -> Measurement | None:
        imu = []
        while self.imu and self.imu[0].t < t_end:
            imu.append(self.imu.popleft())
        if self.imu:
            imu.append(self.imu[0])  # one-past sample (reference keeps it)
        pts, rels = [], []
        while self.points and self.points[0][0] < t_end:
            _, p, rt = self.points.popleft()
            pts.append(p)
            rels.append(rt)
        begin = self.last_get
        self.last_get = t_end
        if not pts:
            return None
        return Measurement(
            time_sweep_begin=begin,
            time_sweep_delta=t_end - begin,
            time_image=t_end,
            points=np.asarray(pts),
            rel_time=np.asarray(rels),
            imu=imu,
            image=image,
            rendering=rendering,
        )

    def get(self) -> list[Measurement]:
        """Drain ALL ready packets (the reference's getMeasurements loops
        until no packet can be formed, lioOptimization.cpp:852-958 — a burst
        of buffered lidar/images must not be rationed one packet per push)."""
        out = []
        while True:
            if not self.imu or not self.images or not self.points:
                return out
            img = self.images[0]
            if self.points[-1][0] <= img.t:
                return out  # lidar not caught up to the image yet
            if self.points[0][0] >= img.t:
                self.images.popleft()  # image predates all points -> drop
                continue
            if self.imu[-1].t <= img.t:
                return out  # imu not caught up
            if self.imu[0].t >= img.t:
                self.images.popleft()
                continue

            if self.last_get < 0:
                self.last_get = self.points[0][0]

            if self.last_get + self.sweep_interval < img.t - self.sweep_interval:
                # non-rendering filler packet at the sweep interval
                m = self._emit(self.last_get + self.sweep_interval, None,
                               rendering=False)
            else:
                self.images.popleft()
                m = self._emit(img.t, img.image, rendering=True)
            if m is not None:
                out.append(m)
            # loop: keep emitting while further packets are ready
