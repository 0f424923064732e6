"""The benchmark's traffic generator: the synthetic textured room, its
ray-cast images, LiDAR-style surface samples, and closed periodic paths
through it.

Frozen copy of `gslivm_tpu_torch/frontend/synthetic.py` (the scene of
`default_scene`, `_texture`, `_intersect`, `render_image`,
`sample_surface_points`, and the dolly of `make_trajectory`), rewritten
in torch so that it runs on the card from a `torch.Generator`, and with
three changes:

- the paths are closed and periodic: the dolly goes out and back along
  s(tau) = (1 - cos(2 pi tau / T)) / 2, so position, velocity and
  acceleration are the same at both ends of a cycle, and a stream can be
  replayed cycle after cycle with shifted timestamps;
- every random draw comes from one generator seeded with `--seed`;
- a sweep's points are thinned as the program's front end thins them
  before the mapper sees them (`thin`).

It imports nothing of the program: the drivers turn what it makes into
the program's frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SWEEP_DT = 0.1        # 10 Hz LiDAR and camera
POINT_NOISE = 0.003   # metres, the synthetic LiDAR's range noise

# (point, normal, u axis, half extent): floor y=+1.5, far wall z=6, the
# two side walls x=-3 and x=+3 (synthetic.default_scene)
PLANES = (
    ((0.0, 1.5, 3.0), (0.0, -1.0, 0.0), (1.0, 0.0, 0.0), 4.0),
    ((0.0, 0.0, 6.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0), 4.0),
    ((-3.0, 0.0, 3.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 4.0),
    ((3.0, 0.0, 3.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0), 4.0),
)
_BASE = ((0.85, 0.3, 0.25), (0.25, 0.7, 0.35), (0.25, 0.4, 0.85),
         (0.8, 0.75, 0.3), (0.7, 0.35, 0.75), (0.4, 0.75, 0.8))


def texture(plane_id: int, u, v):
    """The smooth procedural RGB texture in [0, 1], [..., 3]."""
    base = torch.tensor(_BASE[plane_id % 6], dtype=u.dtype, device=u.device)
    mod = 0.25 * torch.sin(3.0 * u)[..., None] * torch.cos(2.0 * v)[..., None]
    mod2 = 0.15 * torch.sin(9.0 * u + 5.0 * v)[..., None]
    return torch.clamp(base + mod + mod2, 0.0, 1.0)


def _plane(pid: int, dtype, device):
    p, n, ua, ext = PLANES[pid]
    t = [torch.tensor(x, dtype=dtype, device=device) for x in (p, n, ua)]
    return t[0], t[1], t[2], torch.linalg.cross(t[1], t[2]), ext


def intersect(origins, dirs, pid: int):
    """Ray-plane intersection with plane `pid`: (t, u, v, hit)."""
    point, normal, u_axis, v_axis, ext = _plane(pid, dirs.dtype, dirs.device)
    denom = dirs @ normal
    ok = denom.abs() > 1e-9
    t = ((point - origins) @ normal) / torch.where(ok, denom, torch.full_like(denom, 1e-9))
    rel = origins + t[..., None] * dirs - point
    u, v = rel @ u_axis, rel @ v_axis
    hit = ok & (t > 0.05) & (u.abs() <= ext) & (v.abs() <= ext)
    return t, u, v, hit


def cast(origins, dirs):
    """Nearest surface along each ray: (t [...], colour [..., 3]); t is
    inf and the colour white (the background) where no plane is hit."""
    best = torch.full(dirs.shape[:-1], math.inf, dtype=dirs.dtype, device=dirs.device)
    color = torch.ones(dirs.shape, dtype=dirs.dtype, device=dirs.device)
    for pid in range(len(PLANES)):
        t, u, v, hit = intersect(origins, dirs, pid)
        closer = hit & (t < best)
        best = torch.where(closer, t, best)
        color = torch.where(closer[..., None], texture(pid, u, v), color)
    return best, color


# ----------------------------------------------------------------------
# closed periodic paths
# ----------------------------------------------------------------------


class Path(NamedTuple):
    """An out-and-back dolly: centre origin + span * s(tau) and yaw
    yaw0 + yaw_span * s(tau) about the world y axis, with
    s(tau) = (1 - cos(2 pi tau / period)) / 2."""

    origin: tuple
    span: tuple
    yaw0_deg: float
    yaw_span_deg: float
    period_s: float

    @staticmethod
    def from_dict(d: dict) -> "Path":
        return Path(tuple(d["origin"]), tuple(d["span"]), float(d["yaw0_deg"]),
                    float(d["yaw_span_deg"]), float(d["period_s"]))

    def _s(self, tau):
        return (1.0 - torch.cos(2.0 * math.pi / self.period_s * tau)) / 2.0

    def center(self, tau):
        s = self._s(tau)
        o = torch.tensor(self.origin, dtype=tau.dtype, device=tau.device)
        return o + s[..., None] * torch.tensor(self.span, dtype=tau.dtype, device=tau.device)

    def rotation(self, tau):
        """Camera -> world rotations [..., 3, 3] (the yaw of
        synthetic.make_trajectory)."""
        yaw = torch.deg2rad(self.yaw0_deg + self.yaw_span_deg * self._s(tau))
        c, s = torch.cos(yaw), torch.sin(yaw)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                            torch.stack([-s, z, c], -1)], -2)


def pixel_rays(R_wc, width: int, height: int, fx: float, fy: float):
    """World directions [H, W, 3] of a centred pinhole's pixels."""
    dev, dt = R_wc.device, R_wc.dtype
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dt, device=dev),
                            torch.arange(width, dtype=dt, device=dev), indexing="ij")
    d_cam = torch.stack([(xs - (width - 1) / 2.0) / fx, (ys - (height - 1) / 2.0) / fy,
                         torch.ones_like(xs)], dim=-1)
    return d_cam @ R_wc.T


def render_image(R_wc, center, width: int, height: int, fx: float, fy: float):
    """Ray-cast RGB image [H, W, 3] uint8 on the path's device."""
    _, color = cast(center.expand(height, width, 3), pixel_rays(R_wc, width, height, fx, fy))
    return (color * 255.0).to(torch.uint8)


def sample_points(R_wc, center, tan_x: float, tan_y: float, n: int, gen):
    """LiDAR-style samples: n random rays within 1.2x the camera's field of
    view from `center`; the hits plus N(0, POINT_NOISE) noise, [M, 3]
    world, M <= n (rays that hit nothing are dropped)."""
    dev, dt = center.device, center.dtype
    u = torch.rand((n, 2), generator=gen, dtype=dt, device=dev) * 2.0 - 1.0
    d_cam = torch.stack([1.2 * tan_x * u[:, 0], 1.2 * tan_y * u[:, 1],
                         torch.ones(n, dtype=dt, device=dev)], dim=-1)
    dirs = d_cam @ R_wc.T
    t, _ = cast(center.expand(n, 3), dirs)
    noise = torch.randn((n, 3), generator=gen, dtype=dt, device=dev) * POINT_NOISE
    pts = center + t[:, None] * dirs + noise
    return pts[torch.isfinite(t)]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    return gen


# ----------------------------------------------------------------------
# the cells' inputs
# ----------------------------------------------------------------------


class MapFrame(NamedTuple):
    """One camera frame of a path: pose, image, the LiDAR's world points."""

    R_wc: np.ndarray     # [3, 3] float64
    center: np.ndarray   # [3] float64
    image: np.ndarray    # [H, W, 3] uint8
    points: np.ndarray   # [M, 3] float64 world


def thin(points, R_wc, center, filter_num: int, voxel: float) -> np.ndarray:
    """A sweep's world points [M, 3] as the front end hands them on: every
    `filter_num`-th point (sensors.py's point_filter_num), then the first
    point of each `voxel`-sized voxel of the sensor's frame (the pose
    R_wc, centre) in the sweep's order (odometry's grid_sample), kept in
    that order."""
    pts = points[::max(int(filter_num), 1)]
    if voxel <= 0 or len(pts) == 0:
        return pts.cpu().numpy()
    local = ((pts - center) @ R_wc).cpu().numpy()
    pts = pts.cpu().numpy()
    keys = np.floor(local / voxel).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(first)]


def map_frames(path: Path, n: int, width: int, height: int, fx: float, fy: float,
               lidar: dict, seed: int, device) -> list[MapFrame]:
    """n frames at SWEEP_DT along `path` (one cycle when n = period / dt);
    each sweep casts lidar["sweep_points"] rays, thinned by
    lidar["point_filter_num"] and lidar["voxel_size"]."""
    gen = generator(seed, device)
    taus = torch.arange(n, dtype=torch.float64, device=device) * SWEEP_DT
    Rs, cs = path.rotation(taus), path.center(taus)
    tan_x, tan_y = width / (2.0 * fx), height / (2.0 * fy)
    out = []
    for i in range(n):
        img = render_image(Rs[i], cs[i], width, height, fx, fy)
        pts = sample_points(Rs[i], cs[i], tan_x, tan_y, lidar["sweep_points"], gen)
        out.append(MapFrame(Rs[i].cpu().numpy(), cs[i].cpu().numpy(), img.cpu().numpy(),
                            thin(pts, Rs[i], cs[i], lidar["point_filter_num"],
                                 lidar["voxel_size"])))
    return out
