"""Synthetic LiDAR-visual dataset: textured planes, ray-cast images, and
surface point samples.

Stands in for the rosbag datasets of the reference (R3LIVE / FAST-LIVO /
NTU VIRAL / Botanic Garden, SURVEY §6) in tests and benchmarks: a closed
scene of colored planes, a camera trajectory, per-frame ray-cast RGB images
(the photometric ground truth) and LiDAR-style surface points with exact
colors — everything the mapping pipeline consumes, with known geometry.

The port's own copy of gslivm_tpu/frontend/synthetic.py: images and points
are made in numpy exactly as there (bit for bit), from the cameras'
float32 values; only the cameras and their colorization projections are
tensors, on `device`. `dolly_stream` (the port's own addition) makes the
raw sensor streams of tests/test_e2e_regression.py's moving dolly for the
LIVO front end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from ..models.cameras import Camera, make_camera
from ..ops.gp3d import CameraProjection
from ..pipeline import Frame
from .sensors import LidarSweep


class Plane(NamedTuple):
    point: np.ndarray   # [3] a point on the plane
    normal: np.ndarray  # [3] unit normal (toward the scene interior)
    u_axis: np.ndarray  # [3] in-plane texture axis
    extent: float       # half-size of the textured square


def _texture(plane_id: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Smooth procedural RGB texture in [0,1]; [..., 3]."""
    base = np.asarray([
        [0.85, 0.3, 0.25], [0.25, 0.7, 0.35], [0.25, 0.4, 0.85],
        [0.8, 0.75, 0.3], [0.7, 0.35, 0.75], [0.4, 0.75, 0.8],
    ])[plane_id % 6]
    mod = 0.25 * np.sin(3.0 * u)[..., None] * np.cos(2.0 * v)[..., None]
    mod2 = 0.15 * np.sin(9.0 * u + 5.0 * v)[..., None]
    return np.clip(base + mod + mod2, 0.0, 1.0)


def default_scene() -> list[Plane]:
    """A 6m box room around the origin (floor, far wall, two side walls)."""
    e3 = np.eye(3)
    return [
        Plane(np.array([0.0, 1.5, 3.0]), -e3[1], e3[0], 4.0),   # floor y=+1.5
        Plane(np.array([0.0, 0.0, 6.0]), -e3[2], e3[0], 4.0),   # far wall
        Plane(np.array([-3.0, 0.0, 3.0]), e3[0], e3[2], 4.0),   # left wall
        Plane(np.array([3.0, 0.0, 3.0]), -e3[0], e3[2], 4.0),   # right wall
    ]


def _host(t) -> np.ndarray:
    """A camera tensor's float32 values as numpy."""
    return t.detach().cpu().numpy()


def _intersect(origins, dirs, plane: Plane):
    """Ray-plane intersection: returns (t, u, v, hit_mask)."""
    denom = dirs @ plane.normal
    t = ((plane.point - origins) @ plane.normal) / np.where(
        np.abs(denom) > 1e-9, denom, 1e-9)
    hit = (np.abs(denom) > 1e-9) & (t > 0.05)
    pts = origins + t[..., None] * dirs
    rel = pts - plane.point
    u = rel @ plane.u_axis
    v_axis = np.cross(plane.normal, plane.u_axis)
    v = rel @ v_axis
    hit &= (np.abs(u) <= plane.extent) & (np.abs(v) <= plane.extent)
    return t, u, v, hit


def undistort_normalized(xd: np.ndarray, yd: np.ndarray, dist, iters: int = 20):
    """Invert OpenCV's radial-tangential model (k1, k2, p1, p2[, k3]) on
    normalised image coordinates by cv::undistortPoints' fixed-point
    iteration; returns the pinhole (x, y)."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) * icdist, (yd - dy) * icdist
    return x, y


def render_image(camera: Camera, planes: list[Plane], distortion=None) -> np.ndarray:
    """Ray-cast ground-truth RGB image [H, W, 3] uint8. With OpenCV
    `distortion` coefficients, each pixel's ray is that of a distorted
    camera (the image a lens with them records)."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xn, yn = (xs - cx) / fx, (ys - cy) / fy
    if distortion is not None:
        xn, yn = undistort_normalized(xn, yn, distortion)
    d_cam = np.stack([xn, yn, np.ones_like(xs, np.float64)], axis=-1)
    R_wc = _host(camera.R_cw).T
    dirs = d_cam @ R_wc.T
    dirs = dirs.reshape(-1, 3)
    origins = np.broadcast_to(_host(camera.cam_center).astype(np.float64),
                              dirs.shape)

    best_t = np.full(dirs.shape[0], np.inf)
    color = np.ones((dirs.shape[0], 3))
    for pid, plane in enumerate(planes):
        t, u, v, hit = _intersect(origins, dirs, plane)
        closer = hit & (t < best_t)
        best_t = np.where(closer, t, best_t)
        tex = _texture(pid, u[closer], v[closer])
        color[closer] = tex
    img = (color.reshape(H, W, 3) * 255.0).astype(np.uint8)
    return img


def render_depth(camera: Camera, planes: list[Plane]) -> np.ndarray:
    """Ray-cast ground-truth camera-frame depth [H, W] float32 (inf where
    no surface is hit). The pinhole rays have z_cam = 1, so the camera-z
    depth equals the ray parameter t — directly comparable to the
    rasterizer's depth output (D = sum d*alpha*T with d = view-space z)."""
    H, W = camera.height, camera.width
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d_cam = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], axis=-1
    )
    R_wc = _host(camera.R_cw).T
    dirs = (d_cam @ R_wc.T).reshape(-1, 3)
    origins = np.broadcast_to(_host(camera.cam_center).astype(np.float64),
                              dirs.shape)
    best_t = np.full(dirs.shape[0], np.inf)
    for plane in planes:
        t, _, _, hit = _intersect(origins, dirs, plane)
        best_t = np.where(hit & (t < best_t), t, best_t)
    return best_t.reshape(H, W).astype(np.float32)


def sample_surface_points(
    camera: Camera, planes: list[Plane], n: int, rng: np.random.Generator
) -> np.ndarray:
    """LiDAR-style sampling: random rays from the camera center that hit
    scene surfaces -> world points (the stand-in for motion-compensated,
    colored LiDAR returns)."""
    fov_mult = 1.2
    d_cam = np.stack(
        [
            rng.uniform(-fov_mult * float(camera.tan_fovx),
                        fov_mult * float(camera.tan_fovx), n),
            rng.uniform(-fov_mult * float(camera.tan_fovy),
                        fov_mult * float(camera.tan_fovy), n),
            np.ones(n),
        ],
        axis=-1,
    )
    R_wc = _host(camera.R_cw).astype(np.float64).T
    dirs = d_cam @ R_wc.T
    origins = np.broadcast_to(_host(camera.cam_center).astype(np.float64),
                              dirs.shape)
    best_t = np.full(n, np.inf)
    for plane in planes:
        t, _, _, hit = _intersect(origins, dirs, plane)
        best_t = np.where(hit & (t < best_t), t, best_t)
    ok = np.isfinite(best_t)
    pts = origins[ok] + best_t[ok, None] * dirs[ok]
    noise = rng.normal(0, 0.003, pts.shape)
    return pts + noise


def make_trajectory(n_frames: int, width: int, height: int,
                    fov: float = 1.0, device="cuda") -> list[Camera]:
    """A slow forward+sideways dolly facing the far wall."""
    cams = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        center = np.array([-0.8 + 1.6 * s, -0.2, 0.4 * s])
        yaw = np.radians(-8.0 + 16.0 * s)
        cj, sj = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
        cams.append(make_camera(R_wc, center, width, height, fovx=fov,
                                fovy=fov * height / width, device=device))
    return cams


def camera_projection(camera: Camera) -> CameraProjection:
    """The undistorted projection of a camera, on the camera's device."""
    return CameraProjection(
        R_wc=camera.R_cw,
        t_wc=camera.t_cw,
        fx=camera.K[0, 0],
        fy=camera.K[1, 1],
        cx=camera.K[0, 2],
        cy=camera.K[1, 2],
        dist=torch.zeros(4, device=camera.device),
    )


def make_sequence(
    n_frames: int = 20,
    width: int = 128,
    height: int = 96,
    points_per_frame: int = 4000,
    seed: int = 0,
    device="cuda",
) -> list[Frame]:
    """A full synthetic sequence of pipeline Frames, cameras on `device`."""
    planes = default_scene()
    cams = make_trajectory(n_frames, width, height, device=device)
    rng = np.random.default_rng(seed)
    frames = []
    for cam in cams:
        img = render_image(cam, planes)
        pts = sample_surface_points(cam, planes, points_per_frame, rng)
        frames.append(Frame(
            points_world=pts,
            image=img,
            camera=cam,
            cam_projection=camera_projection(cam),
        ))
    return frames


# ----------------------------------------------------------------------
# raw sensor streams for the LIVO front end
# ----------------------------------------------------------------------

DOLLY_ORIGIN = np.array([-0.8, -0.2, 0.4])
GRAVITY = np.array([0.0, 0.0, 9.81])
SWEEP_DT, IMU_DT = 0.1, 0.005  # 10 Hz LiDAR and camera, 200 Hz IMU
LIDAR_FOVX = 1.0  # the rays' camera (its fovy follows the image's aspect)


def dolly_position(t) -> np.ndarray:
    """The e2e dolly (tests/test_e2e_regression.py:41-53): accelerate at
    0.3 m/s^2 along +x for 0.5 s, then glide at 0.15 m/s. [..., 3] for
    times [...] since the motion began."""
    t = np.asarray(t, np.float64)
    x = np.where(t < 0.5, 0.5 * 0.3 * t * t, 0.5 * 0.3 * 0.25 + 0.15 * (t - 0.5))
    return DOLLY_ORIGIN + x[..., None] * np.array([1.0, 0.0, 0.0])


class SensorSweep(NamedTuple):
    """One sweep of raw sensor data, pushed in this order: the LiDAR sweep,
    the IMU samples, the image."""

    lidar: LidarSweep
    imu: list  # [(t, gyr [3], acc [3])]
    image_time: float
    image: np.ndarray  # [H, W, 3] uint8
    t_end: float
    gt_displacement: np.ndarray  # [3] at t_end, from where the motion began


class DollyStream(NamedTuple):
    init_imu: list  # the static samples that initialise the ESKF
    sweeps: list[SensorSweep]
    fx: float  # the image camera's intrinsics (centred principal point)
    fy: float
    cx: float
    cy: float


def dolly_stream(n_sweeps: int, width: int, height: int, points_per_sweep: int,
                 seed: int = 0) -> DollyStream:
    """The raw streams of tests/test_e2e_regression.py's runner, on the
    default scene, extended to `n_sweeps`: 80 static IMU samples, then per
    sweep a LiDAR sweep whose points are each sampled from the true pose at
    their own time (true motion distortion; identity attitude), IMU at
    200 Hz with N(0, 1e-3) noise, and one RGB image 0.095 s into the
    sweep. The LiDAR rays are cast through a camera of LIDAR_FOVX at the
    sweep's start. Returns numpy data only."""
    planes = default_scene()
    rng = np.random.default_rng(seed)
    fovx, fovy = LIDAR_FOVX, LIDAR_FOVX * height / width
    sweep_dt, imu_dt = SWEEP_DT, IMU_DT
    t, init = 0.0, []
    for _ in range(80):
        init.append((t, np.zeros(3), GRAVITY + rng.normal(0, 1e-3, 3)))
        t += imu_dt
    t0 = t
    sweeps = []
    for _ in range(n_sweeps):
        tau0 = t
        rel = np.sort(rng.uniform(0.0, sweep_dt * 0.9, points_per_sweep))
        rays = make_camera(np.eye(3), dolly_position(tau0 - t0), width, height,
                           fovx=fovx, fovy=fovy, device="cpu")
        pts_w = sample_surface_points(rays, planes, points_per_sweep, rng)
        rel = rel[: pts_w.shape[0]]
        pts = pts_w - dolly_position(tau0 - t0 + rel)
        lidar = LidarSweep(tau0, pts, rel, np.zeros(len(rel)))
        imu = []
        for j in range(int(round(sweep_dt / imu_dt))):
            ti = tau0 + j * imu_dt
            acc = np.array([0.3 if ti - t0 < 0.5 else 0.0, 0.0, 0.0])
            imu.append((ti, np.zeros(3), acc + GRAVITY + rng.normal(0, 1e-3, 3)))
        img_t = tau0 + 0.095
        cam = make_camera(np.eye(3), dolly_position(img_t - t0), width, height,
                          fovx=fovx, fovy=fovy, device="cpu")
        t = tau0 + sweep_dt
        sweeps.append(SensorSweep(lidar, imu, img_t, render_image(cam, planes), t,
                                  dolly_position(t - t0) - dolly_position(0.0)))
    fx = width / (2.0 * np.tan(fovx / 2.0))
    fy = height / (2.0 * np.tan(fovy / 2.0))
    return DollyStream(init, sweeps, fx, fy, (width - 1) / 2.0, (height - 1) / 2.0)
