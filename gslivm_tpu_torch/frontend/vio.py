"""Visual-inertial processing: LK tracking, PnP gating, ESIKF visual
updates, and the Bayesian-colored point map (the port's own copy of
gslivm_tpu/frontend/vio.py: numpy on the host as there, with the tracker's
three OpenCV calls replaced by the port's `frontend/vision.py`).

Behavioral spec: reference `src/liw/imageProcessing.cpp`,
`opticalFlowTracker.cpp`, `rgbMapTracker.cpp`, `cloudMap.cpp`:

  - optical flow: pyramidal LK frame-to-frame tracking of projected map
    points (the reference vendors OpenCV's lkpyramid with SSE2,
    lkpyramid.cpp:1; the JAX package calls OpenCV, the port `vision.lk_track`),
    fundamental-matrix RANSAC gate (opticalFlowTracker.cpp:135-140),
    per-point image velocity (151-158), RANSAC PnP outlier rejection
    (257-316), track top-up from the projection list (13-92, max 300).
    The port runs `vision.lk_track`, `vision.fundamental_ransac` and
    `vision.pnp_ransac` on host tensors with the same arguments, their
    draws from the tracker's own seeded `torch.Generator`.
  - vioEsikf (imageProcessing.cpp:270-417): 11-dim state [td, R_ic(3),
    t_ic(3), fx, fy, cx, cy]. With ifEstimateExtrinsic/Intrinsic hardcoded
    false (imageProcessing.cpp:20-21) the measurement Jacobian has only the
    pixel-velocity (td) column — the update effectively estimates the
    camera-IMU time offset; reproduced faithfully.
  - vioPhotometric (440-602): 6-dim RGB photometric update whose H is zero
    under the same hardcoded flags — inert in the live config; we implement
    the td-active esikf and keep the photometric covariance bookkeeping.
  - rgbPoint::updateRgb (cloudMap.cpp:53-93): recursive-Bayes per-channel
    color fusion with process noise 0.1*dt, obs sigma 15, and the 1.2x
    observation-distance rejection; renderPointsInRecentVoxel
    (rgbMapTracker.cpp:170-233) applies it to recently-visited voxels.
  - selectPointsForProjection (rgbMapTracker.cpp:45-142): depth-buffered 2D
    grid masking to pick well-spread map points for tracking.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..config import MapOptions
from . import so3, vision

IMAGE_OBS_COV = 15.0       # cloudMap.cpp:49
PROCESS_NOISE_SIGMA = 0.1  # cloudMap.cpp:50
MIN_ITER_POINTS = 10       # imageProcessing.cpp:268


def huber_scale(residual: float, outlier_threshold: float = 1.0) -> float:
    """getHuberLoss (imageProcessing.cpp:256-266)."""
    if residual / outlier_threshold < 1.0:
        return 1.0
    return (2 * np.sqrt(residual) / np.sqrt(outlier_threshold) - 1.0) / residual


class ColorPointMap:
    """Colored map points in a voxel grid (color_voxel_map + rgbMapTracker).

    Struct-of-arrays storage; every point carries the recursive-Bayes color
    state (rgb, per-channel sigma, N_rgb, observe_distance, last obs time)
    and a 2D image velocity for the td estimation.
    """

    def __init__(self, opts: MapOptions = MapOptions()):
        self.opts = opts
        self.position = np.zeros((0, 3))
        self.rgb = np.zeros((0, 3))
        self.cov_rgb = np.zeros((0, 3))
        self.n_rgb = np.zeros(0, np.int32)
        self.obs_distance = np.zeros(0)
        self.last_obs_time = np.zeros(0)
        self.image_velocity = np.zeros((0, 2))
        self.voxels: dict[tuple, list[int]] = {}
        self._dedup: set[tuple] = set()
        self.recent_voxels: list[tuple] = []

    def __len__(self):
        return self.position.shape[0]

    def add_points(self, points_world: np.ndarray, step: int | None = None):
        """addPointToColorMap (lioOptimization.cpp:599-666): voxel capacity
        + min-distance dedup grid; tracks recently-visited voxels."""
        o = self.opts
        step = step or o.add_point_step
        pts = np.asarray(points_world, np.float64)[::max(step, 1)]
        recent: dict[tuple, None] = {}
        new_rows = []
        for p in pts:
            key = tuple(np.trunc(p / o.size_voxel_map).astype(np.int64))
            dkey = tuple(np.trunc(p / o.min_distance_points).astype(np.int64))
            recent[key] = None
            lst = self.voxels.setdefault(key, [])
            if len(lst) >= o.max_num_points_in_voxel:
                continue
            if dkey in self._dedup:
                continue
            self._dedup.add(dkey)
            lst.append(len(self.position) + len(new_rows))
            new_rows.append(p)
        if new_rows:
            n = len(new_rows)
            self.position = np.concatenate([self.position, np.asarray(new_rows)])
            self.rgb = np.concatenate([self.rgb, np.zeros((n, 3))])
            self.cov_rgb = np.concatenate([self.cov_rgb, np.zeros((n, 3))])
            self.n_rgb = np.concatenate([self.n_rgb, np.zeros(n, np.int32)])
            self.obs_distance = np.concatenate([self.obs_distance, np.zeros(n)])
            self.last_obs_time = np.concatenate([self.last_obs_time, np.zeros(n)])
            self.image_velocity = np.concatenate([self.image_velocity,
                                                  np.zeros((n, 2))])
        self.recent_voxels = list(recent.keys())
        return len(new_rows)

    # ---- Bayesian color update (cloudMap.cpp:53-93, vectorized) ----------

    def update_rgb(self, idx: np.ndarray, colors: np.ndarray,
                   distances: np.ndarray, obs_time: float):
        """Vectorized rgbPoint::updateRgb over the point indices idx."""
        idx = np.asarray(idx)
        if idx.size == 0:
            return 0
        colors = np.asarray(colors, np.float64)
        distances = np.asarray(distances, np.float64)

        seen = self.n_rgb[idx] > 0
        reject = seen & (self.obs_distance[idx] != 0) & (
            distances > self.obs_distance[idx] * 1.2)
        use = ~reject

        first = use & ~seen
        fi = idx[first]
        self.rgb[fi] = np.round(colors[first])
        self.cov_rgb[fi] = IMAGE_OBS_COV
        self.obs_distance[fi] = distances[first]
        self.last_obs_time[fi] = obs_time
        self.n_rgb[fi] = 1

        upd = use & seen
        ui = idx[upd]
        if ui.size:
            dt = obs_time - self.last_obs_time[ui]
            sigma = self.cov_rgb[ui] + (PROCESS_NOISE_SIGMA * dt)[:, None]
            old_sigma = sigma.copy()
            obs_sigma = IMAGE_OBS_COV
            new_sigma = np.sqrt(1.0 / (1.0 / sigma**2 + 1.0 / obs_sigma**2))
            self.rgb[ui] = new_sigma**2 * (
                self.rgb[ui] / old_sigma**2 + colors[upd] / obs_sigma**2)
            self.cov_rgb[ui] = new_sigma
            closer = distances[upd] < self.obs_distance[ui]
            self.obs_distance[ui] = np.where(closer, distances[upd],
                                             self.obs_distance[ui])
            self.last_obs_time[ui] = obs_time
            self.n_rgb[ui] += 1
        return int(ui.size) if ui.size else 0

    def render_recent(self, image: np.ndarray, R_cw: np.ndarray,
                      t_cw: np.ndarray, K: np.ndarray, cam_center: np.ndarray,
                      obs_time: float):
        """renderPointsInRecentVoxel: Bayesian color update of all points in
        recently-visited voxels visible in this frame."""
        idx = [i for key in self.recent_voxels for i in self.voxels.get(key, [])]
        if not idx:
            return 0
        idx = np.asarray(idx)
        pts = self.position[idx]
        p_cam = pts @ R_cw.T + t_cw
        z = p_cam[:, 2]
        ok = z > 1e-3
        u = K[0, 0] * p_cam[:, 0] / np.where(ok, z, 1) + K[0, 2]
        v = K[1, 1] * p_cam[:, 1] / np.where(ok, z, 1) + K[1, 2]
        H, W = image.shape[:2]
        ok &= (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        if not ok.any():
            return 0
        idx, u, v = idx[ok], u[ok], v[ok]
        colors = _bilinear(image, u, v)
        dist = np.linalg.norm(self.position[idx] - cam_center, axis=1)
        return self.update_rgb(idx, colors, dist, obs_time)

    def select_points_for_projection(self, R_cw, t_cw, K, width, height,
                                     min_dist: float = 10.0,
                                     min_views: int = 0):
        """selectPointsForProjection (rgbMapTracker.cpp:45-142): project map
        points, keep the nearest per 2D grid cell of size min_dist px."""
        if len(self) == 0:
            return np.zeros(0, np.int64), np.zeros((0, 2))
        pts = self.position
        mask = self.n_rgb >= min_views
        p_cam = pts @ R_cw.T + t_cw
        z = p_cam[:, 2]
        ok = mask & (z > 1e-3)
        u = K[0, 0] * p_cam[:, 0] / np.where(ok, z, 1) + K[0, 2]
        v = K[1, 1] * p_cam[:, 1] / np.where(ok, z, 1) + K[1, 2]
        ok &= (u >= 0) & (u < width) & (v >= 0) & (v < height)
        idx = np.nonzero(ok)[0]
        if idx.size == 0:
            return np.zeros(0, np.int64), np.zeros((0, 2))
        cell = (np.trunc(v[idx] / min_dist).astype(np.int64) * 100000
                + np.trunc(u[idx] / min_dist).astype(np.int64))
        best: dict[int, tuple[float, int]] = {}
        for i, c, d in zip(idx, cell, z[idx]):
            cur = best.get(c)
            if cur is None or d < cur[0]:
                best[c] = (d, i)
        sel = np.asarray([i for _, i in best.values()])
        return sel, np.stack([u[sel], v[sel]], axis=1)


def _bilinear(image: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear RGB sample ([N,3] float) at sub-pixel coords."""
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    wx = (u - x0)[:, None]
    wy = (v - y0)[:, None]
    img = image.astype(np.float64)
    return ((img[y0, x0] * (1 - wx) + img[y0, x0 + 1] * wx) * (1 - wy)
            + (img[y0 + 1, x0] * (1 - wx) + img[y0 + 1, x0 + 1] * wx) * wy)


@dataclasses.dataclass
class VioState:
    """The 11-dim ESIKF visual state (imageProcessing.h:47, 88-94)."""

    time_td: float = 0.0
    R_ic: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    t_ic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    fx: float = 400.0
    fy: float = 400.0
    cx: float = 320.0
    cy: float = 240.0
    covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(11) * 1e-3)


class OpticalFlowTracker:
    """Frame-to-frame LK track set over colored map points (on
    `frontend/vision.py`; RANSAC draws from its own generator, seeded 0).
    `seconds` accumulates the host seconds of its lk, f_ransac and pnp."""

    def __init__(self, max_tracks: int = 300):
        self.max_tracks = max_tracks
        self.generator = torch.Generator().manual_seed(0)
        self.seconds: collections.defaultdict = collections.defaultdict(float)
        self.prev_gray: torch.Tensor | None = None
        self.track_uv = np.zeros((0, 2), np.float32)
        self.track_idx = np.zeros(0, np.int64)
        self.last_time: float | None = None

    def top_up(self, sel_idx: np.ndarray, sel_uv: np.ndarray,
               min_sep: float = 10.0):
        """updateAndAppendTrackPoints: add well-separated new tracks."""
        have = set(self.track_idx.tolist())
        new_uv, new_idx = [], []
        for i, uv in zip(sel_idx, sel_uv):
            if len(self.track_idx) + len(new_idx) >= self.max_tracks:
                break
            if int(i) in have:
                continue
            if len(self.track_uv) and np.min(
                    np.linalg.norm(self.track_uv - uv, axis=1)) < min_sep:
                continue
            new_uv.append(uv)
            new_idx.append(int(i))
        if new_idx:
            self.track_uv = np.concatenate(
                [self.track_uv, np.asarray(new_uv, np.float32)])
            self.track_idx = np.concatenate(
                [self.track_idx, np.asarray(new_idx)])

    def track(self, gray: torch.Tensor, t: float, cmap: ColorPointMap) -> bool:
        """trackImage (opticalFlowTracker.cpp:103-181): LK + fundamental
        RANSAC + image-velocity update. gray: [H, W] uint8 host tensor."""
        if self.prev_gray is None or len(self.track_uv) < 8:
            self.prev_gray = gray
            self.last_time = t
            return len(self.track_uv) >= 8
        t0 = time.perf_counter()
        nxt, status = vision.lk_track(self.prev_gray, gray,
                                      torch.from_numpy(self.track_uv))
        nxt, ok = nxt.numpy(), status.numpy().copy()
        t1 = time.perf_counter()
        self.seconds["lk"] += t1 - t0
        H, W = gray.shape[:2]
        inb = ((nxt[:, 0] >= 0) & (nxt[:, 0] < W)
               & (nxt[:, 1] >= 0) & (nxt[:, 1] < H))
        ok &= inb
        if ok.sum() >= 8:
            f_mask = vision.fundamental_ransac(
                torch.from_numpy(self.track_uv[ok]), torch.from_numpy(nxt[ok]),
                3.0, 0.99, generator=self.generator)
            if f_mask is not None:
                keep = np.nonzero(ok)[0][f_mask.numpy()]
                mask2 = np.zeros_like(ok)
                mask2[keep] = True
                ok = mask2
        self.seconds["f_ransac"] += time.perf_counter() - t1
        dt = max(t - (self.last_time or t), 1e-6)
        vel = (nxt - self.track_uv) / dt
        cmap.image_velocity[self.track_idx[ok]] = vel[ok]
        self.track_uv = nxt[ok]
        self.track_idx = self.track_idx[ok]
        self.prev_gray = gray
        self.last_time = t
        return len(self.track_uv) >= 8

    def ransac_pnp(self, cmap: ColorPointMap, K: np.ndarray) -> bool:
        """removeOutlierUsingRansacPnp (opticalFlowTracker.cpp:257-316)."""
        if len(self.track_uv) < MIN_ITER_POINTS:
            return False
        obj = cmap.position[self.track_idx].astype(np.float64)
        img = self.track_uv.astype(np.float64)
        t0 = time.perf_counter()
        ok, _, _, inliers = vision.pnp_ransac(
            torch.from_numpy(obj), torch.from_numpy(img),
            torch.from_numpy(np.asarray(K, np.float64)),
            reprojection_error=8.0, iterations=100, generator=self.generator)
        self.seconds["pnp"] += time.perf_counter() - t0
        if not ok or int(inliers.sum()) < MIN_ITER_POINTS:
            return False
        keep = np.nonzero(inliers.numpy())[0]
        self.track_uv = self.track_uv[keep]
        self.track_idx = self.track_idx[keep]
        return True


def _image_color_grad(image: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Bilinear color + central-difference color gradients (the reference's
    getRgb(u, v, 0, &dx, &dy), cloudFrame path)."""
    c0 = _bilinear(image, u, v)
    cdx = (_bilinear(image, np.clip(u + 1, 0, image.shape[1] - 2), v)
           - _bilinear(image, np.clip(u - 1, 0, image.shape[1] - 2), v)) / 2.0
    cdy = (_bilinear(image, u, np.clip(v + 1, 0, image.shape[0] - 2))
           - _bilinear(image, u, np.clip(v - 1, 0, image.shape[0] - 2))) / 2.0
    return c0, cdx, cdy


def vio_photometric(state: VioState, cmap: ColorPointMap,
                    track_idx: np.ndarray, image: np.ndarray,
                    R_wi: np.ndarray, t_wi: np.ndarray,
                    number_new_voxels: int, num_iterations: int = 2,
                    estimate_extrinsic: bool = False):
    """vioPhotometric (imageProcessing.cpp:440-602): 6-dim [so3_ic, t_ic]
    RGB photometric update against the Bayesian point colors.

    With estimate_extrinsic=False (the reference's hardcoded live config,
    imageProcessing.cpp:20-21) the measurement Jacobian is zero and the
    update is inert except for the covariance bookkeeping — reproduced for
    parity. estimate_extrinsic=True enables the full update (a capability
    the reference ships disabled). Returns (state, mean_sq_residual).

    R_wi/t_wi: IMU->world pose; the camera pose derives from state.R_ic/t_ic.
    """
    idx = np.asarray(track_idx)
    seen = cmap.n_rgb[idx] >= 3  # N_rgb < 3 skipped (imageProcessing.cpp:503)
    idx = idx[seen]
    n = len(idx)
    if n < MIN_ITER_POINTS:
        return state, 0.0
    weight = max(0.001, min(5.0 / max(number_new_voxels, 1), 0.01))
    H_img, W_img = image.shape[:2]

    q_pred_R = state.R_ic.copy()
    t_pred = state.t_ic.copy()
    last_acc = 3e8
    K_full = np.zeros((6, 3 * n))
    H = np.zeros((3 * n, 6))
    P6 = state.covariance[1:7, 1:7]

    for _ in range(num_iterations):
        R_wc = (R_wi @ state.R_ic)
        c = R_wi @ state.t_ic + t_wi
        R_cw = R_wc.T
        t_cw = -R_cw @ c

        pts = cmap.position[idx]
        p_cam = pts @ R_cw.T + t_cw
        z = np.where(p_cam[:, 2] > 1e-6, p_cam[:, 2], 1e-6)
        u = state.fx * p_cam[:, 0] / z + state.cx
        v = state.fy * p_cam[:, 1] / z + state.cy
        inb = (u >= 1) & (u < W_img - 2) & (v >= 1) & (v < H_img - 2)
        if inb.sum() < MIN_ITER_POINTS:
            return state, 0.0
        uu, vv = np.where(inb, u, 1.0), np.where(inb, v, 1.0)
        obs, cdx, cdy = _image_color_grad(image, uu, vv)
        resid = obs - cmap.rgb[idx]
        resid[~inb] = 0.0
        rn = np.linalg.norm(resid, axis=1)
        hub = np.asarray([huber_scale(r) for r in rn])

        rgb_cov = np.maximum(cmap.cov_rgb[idx], 1e-3)
        r_inv = 1.0 / rgb_cov**2  # [n, 3] information diag

        r_vec = (resid * hub[:, None]).reshape(-1)
        acc = float((resid**2 * r_inv).sum())

        H[:, :] = 0.0
        if estimate_extrinsic:
            for i in range(n):
                if not inb[i]:
                    continue
                J_u_pc = np.array([
                    [state.fx / z[i], 0.0, -state.fx * p_cam[i, 0] / z[i]**2],
                    [0.0, state.fy / z[i], -state.fy * p_cam[i, 1] / z[i]**2],
                ])
                J_color_u = np.stack([cdx[i], cdy[i]], axis=1)  # [3, 2]
                J_color_pc = J_color_u @ J_u_pc  # [3, 3]
                H[3 * i:3 * i + 3, 0:3] = (
                    J_color_pc @ so3.skew(p_cam[i]) * hub[i])
                H[3 * i:3 * i + 3, 3:6] = (
                    -J_color_pc @ state.R_ic.T * hub[i])

        d_so3 = so3.rot_to_so3(q_pred_R.T @ state.R_ic)
        d_x = np.concatenate([d_so3, state.t_ic - t_pred])
        J0 = np.eye(6)
        J0[0:3, 0:3] = np.eye(3) - 0.5 * so3.skew(d_so3)

        HtR = H.T * np.repeat(r_inv.reshape(-1), 1)  # [6, 3n]
        eq_inv = np.linalg.inv(J0 @ P6 @ J0.T * weight)
        K_full = np.linalg.solve(HtR @ H + eq_inv, HtR)
        sol = -K_full @ r_vec - (np.eye(6) - K_full @ H) @ J0 @ d_x

        state.R_ic = state.R_ic @ so3.so3_to_rot(sol[0:3])
        state.t_ic = state.t_ic + sol[3:6]

        if acc / n < 10 or abs(acc - last_acc) < 0.01:
            break
        last_acc = acc

    J_k = np.eye(6)
    J_k[0:3, 0:3] = np.eye(3) - 0.5 * so3.skew(sol[0:3])
    state.covariance[1:7, 1:7] = (
        J_k @ (np.eye(6) - K_full @ H) @ P6 @ J_k.T)
    return state, acc / max(n, 1)


def vio_esikf(state: VioState, cmap: ColorPointMap,
              track_idx: np.ndarray, track_uv: np.ndarray,
              R_wi: np.ndarray, t_wi: np.ndarray,
              number_new_voxels: int, num_iterations: int = 2,
              estimate_extrinsic: bool = False,
              estimate_intrinsic: bool = False) -> VioState:
    """vioEsikf (imageProcessing.cpp:270-417): 11-dim ESIKF update
    [td, so3_ic(3), t_ic(3), fx, fy, cx, cy] against tracked-pixel
    reprojection residuals.

    The reference carries the COMPLETE measurement Jacobian but gates the
    extrinsic columns by ifEstimateExtrinsic and the intrinsic columns by
    ifEstimateCameraIntrinsic, both hardcoded false (imageProcessing.cpp:
    20-21, 381-389) — so its live config only refines time_td. The same
    capability lives here behind the same flags; flag-off is numerically
    identical to the td-only update (the covariance starts diagonal and H
    has only column 0, so the gain never mixes the other rows).

    R_wi/t_wi: current IMU->world pose; the camera pose derives from the
    state's extrinsics and is REFRESHED each iteration after the update
    (updateCameraParameters -> refreshPoseForProjection, :419-438).
    """
    n = len(track_idx)
    if n < MIN_ITER_POINTS:
        return state
    weight = max(0.001, min(5.0 / max(number_new_voxels, 1), 0.01))
    td_pred = state.time_td
    R_pred = state.R_ic.copy()
    p_pred = state.t_ic.copy()
    k_pred = np.array([state.fx, state.fy, state.cx, state.cy])
    last_acc = 3e8
    H = np.zeros((2 * n, 11))
    for _ in range(num_iterations):
        R_wc = R_wi @ state.R_ic
        c = R_wi @ state.t_ic + t_wi
        R_cw = R_wc.T
        t_cw = -R_cw @ c

        pts = cmap.position[track_idx]
        vel = cmap.image_velocity[track_idx]
        p_cam = pts @ R_cw.T + t_cw
        z = np.where(p_cam[:, 2] > 1e-6, p_cam[:, 2], 1e-6)
        proj = np.stack([
            state.fx * p_cam[:, 0] / z + state.cx,
            state.fy * p_cam[:, 1] / z + state.cy,
        ], axis=1) + state.time_td * vel
        resid = proj - track_uv
        rn = np.linalg.norm(resid, axis=1)
        hub = np.asarray([huber_scale(r) for r in rn])
        r_vec = (resid * hub[:, None]).reshape(-1)

        H[:, :] = 0.0
        H[:, 0] = (vel * hub[:, None]).reshape(-1)
        if estimate_extrinsic:
            # J_u_pc: projection Jacobian wrt the camera-frame point (:368)
            J_u_pc = np.zeros((n, 2, 3))
            J_u_pc[:, 0, 0] = state.fx / z
            J_u_pc[:, 0, 2] = -state.fx * p_cam[:, 0] / z**2
            J_u_pc[:, 1, 1] = state.fy / z
            J_u_pc[:, 1, 2] = -state.fy * p_cam[:, 1] / z**2
            skews = np.zeros((n, 3, 3))
            skews[:, 0, 1] = -p_cam[:, 2]
            skews[:, 0, 2] = p_cam[:, 1]
            skews[:, 1, 0] = p_cam[:, 2]
            skews[:, 1, 2] = -p_cam[:, 0]
            skews[:, 2, 0] = -p_cam[:, 1]
            skews[:, 2, 1] = p_cam[:, 0]
            # dso3 column (:382) and t_ic column (:383)
            H[:, 1:4] = (np.einsum("nij,njk->nik", J_u_pc, skews)
                         * hub[:, None, None]).reshape(-1, 3)
            H[:, 4:7] = (-(J_u_pc @ state.R_ic.T)
                         * hub[:, None, None]).reshape(-1, 3)
        if estimate_intrinsic:
            # J_u_K (:373-375): d(u,v)/d(fx,fy,cx,cy)
            J_u_K = np.zeros((n, 2, 4))
            J_u_K[:, 0, 0] = p_cam[:, 0] / z
            J_u_K[:, 0, 2] = 1.0
            J_u_K[:, 1, 1] = p_cam[:, 1] / z
            J_u_K[:, 1, 3] = 1.0
            H[:, 7:11] = (J_u_K * hub[:, None, None]).reshape(-1, 4)

        d_x = np.zeros(11)
        d_x[0] = state.time_td - td_pred
        d_x[1:4] = so3.rot_to_so3(R_pred.T @ state.R_ic)
        d_x[4:7] = state.t_ic - p_pred
        d_x[7:11] = np.array([state.fx, state.fy, state.cx, state.cy]) - k_pred
        J0 = np.eye(11)
        J0[1:4, 1:4] = np.eye(3) - 0.5 * so3.skew(d_x[1:4])

        Kmat = np.linalg.solve(
            H.T @ H + np.linalg.inv(J0 @ state.covariance @ J0.T * weight),
            H.T)
        sol = -Kmat @ r_vec - (np.eye(11) - Kmat @ H) @ J0 @ d_x

        # updateCameraParameters (:419-431)
        state.time_td += sol[0]
        state.R_ic = state.R_ic @ so3.so3_to_rot(sol[1:4])
        state.t_ic = state.t_ic + sol[4:7]
        state.fx += sol[7]
        state.fy += sol[8]
        state.cx += sol[9]
        state.cy += sol[10]

        acc = rn.mean()
        if abs(acc - last_acc) < 0.01:
            break
        last_acc = acc

    J_k = np.eye(11)
    J_k[1:4, 1:4] = np.eye(3) - 0.5 * so3.skew(sol[1:4])
    state.covariance = (
        J_k @ (np.eye(11) - Kmat @ H) @ state.covariance @ J_k.T)
    return state


def vio_esikf_td(state: VioState, cmap: ColorPointMap,
                 track_idx: np.ndarray, track_uv: np.ndarray,
                 R_cw: np.ndarray, t_cw: np.ndarray,
                 number_new_voxels: int, num_iterations: int = 2) -> VioState:
    """vioEsikf with the live-config flags (extrinsic/intrinsic estimation
    off): only the time-offset column of H is populated, so the update
    refines time_td. Thin wrapper over vio_esikf taking the camera pose
    directly (it is constant when the extrinsics are not estimated)."""
    # recover an equivalent IMU pose so vio_esikf's extrinsic composition
    # reproduces exactly this camera pose
    R_wi = R_cw.T @ state.R_ic.T
    c = -R_cw.T @ t_cw
    t_wi = c - R_wi @ state.t_ic
    return vio_esikf(state, cmap, track_idx, track_uv, R_wi, t_wi,
                     number_new_voxels, num_iterations=num_iterations)
