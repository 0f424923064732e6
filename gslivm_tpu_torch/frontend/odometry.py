"""LiDAR-inertial odometry: plane-ICP residuals fused by an iterated EKF.
(the port's own copy of gslivm_tpu/frontend/odometry.py; numpy on the host, as there)

Behavioral spec: reference `src/liw/optimize.cpp` + the per-sweep driver in
`lioOptimization.cpp`:

  - buildPlaneResiduals (optimize.cpp:18-134): per grid-sampled keypoint,
    kNN in the voxel map -> PCA plane (computeNeighborhoodDistribution:
    308-343) with normal flipped toward the last position; planarity weight
    a2D^power_planarity blended with a distance kernel; SIGNED point-to-
    plane distance gated < max_dist_to_plane_icp (the reference compares
    the signed value — large negative residuals pass; reproduced);
    jacobian rows [n^T, -n^T R [loc]_x] * weight.
  - updateIEKF (optimize.cpp:136-306): iterated EKF with the ESKF prior:
    d_x = state - predicted in the 17-dim tangent, left-Jacobian
    projections J_k_so3/J_k_s2, gain from (P/laser_point_cov)^-1 + H^T H,
    divergence guard (>100), convergence thresholds on |dp|, |dtheta|,
    final covariance downdate.
  - per-sweep flow (process/buildFrame/stateInitialization,
    lioOptimization.cpp:991-1179): constant-velocity or IMU state init,
    motion compensation to the sweep end, grid-sample keypoints, ICP,
    insert the motion-compensated cloud into the map.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..config import IcpOptions, OdometryOptions
from . import so3
from .eskf import Eskf
from .voxelmap import VoxelMap, grid_sample

LASER_POINT_COV = 0.001  # lioOptimization.cpp:500


class Neighborhood(NamedTuple):
    center: np.ndarray
    normal: np.ndarray
    a2D: float


def compute_neighborhood(points: np.ndarray) -> Neighborhood:
    """computeNeighborhoodDistribution (optimize.cpp:308-343)."""
    bary = points.mean(axis=0)
    centered = points - bary
    cov = centered.T @ centered
    evals, evecs = np.linalg.eigh(cov)
    normal = evecs[:, 0] / np.linalg.norm(evecs[:, 0])
    s1 = np.sqrt(abs(evals[2]))
    s2 = np.sqrt(abs(evals[1]))
    s3 = np.sqrt(abs(evals[0]))
    a2d = (s2 - s3) / max(s1, 1e-12)
    return Neighborhood(bary, normal, float(a2d))


@dataclasses.dataclass
class PlaneResiduals:
    H: np.ndarray       # [M, 6]
    h: np.ndarray       # [M]
    num: int
    success: bool


def build_plane_residuals(
    icp: IcpOptions,
    vmap: VoxelMap,
    keypoints_loc: np.ndarray,  # [K, 3] points in IMU frame (R_il p + t_il)
    q_wxyz: np.ndarray,
    t: np.ndarray,
    last_t: np.ndarray,
    nb_voxels: int,
    threshold_capacity: int,
) -> PlaneResiduals:
    R = so3.quat_to_rot(so3.quat_normalize(q_wxyz))

    if hasattr(vmap, "build_plane_residuals"):
        # native C++ fast path: the whole kNN+PCA+residual loop in one call
        H, h = vmap.build_plane_residuals(
            keypoints_loc, R, t, last_t, nb_voxels, threshold_capacity,
            icp.max_number_neighbors, icp.min_number_neighbors,
            icp.power_planarity, icp.max_dist_to_plane_icp,
            icp.weight_alpha, icp.weight_neighborhood, icp.max_num_residuals)
        num = len(h)
        if num < icp.min_number_neighbors:
            return PlaneResiduals(np.zeros((0, 6)), np.zeros(0), num, False)
        return PlaneResiduals(H, h, num, True)

    world = keypoints_loc @ R.T + t

    lam_w = abs(icp.weight_alpha)
    lam_n = abs(icp.weight_neighborhood)
    ssum = lam_w + lam_n
    lam_w, lam_n = lam_w / ssum, lam_n / ssum
    kmax = icp.max_dist_to_plane_icp

    rows_H, rows_h = [], []
    for loc, wp in zip(keypoints_loc, world):
        neigh = vmap.search_neighbors(
            wp, nb_voxels, icp.max_number_neighbors, threshold_capacity)
        if neigh.shape[0] < icp.min_number_neighbors:
            continue
        nb = compute_neighborhood(neigh)
        normal = nb.normal if nb.normal @ (last_t - loc) >= 0 else -nb.normal
        planarity = nb.a2D ** icp.power_planarity
        weight = (lam_w * planarity
                  + lam_n * np.exp(-np.linalg.norm(neigh[0] - wp)
                                   / (kmax * icp.min_number_neighbors)))
        offset = -normal @ neigh[0]
        dist = normal @ (R @ loc + t) + offset
        if dist < kmax:  # signed compare — reference parity
            jac = np.concatenate([
                normal * weight,
                -(normal @ R @ so3.skew(loc)) * weight,
            ])
            rows_H.append(jac)
            rows_h.append(dist * weight)
        if len(rows_h) >= icp.max_num_residuals:
            break

    num = len(rows_h)
    if num < icp.min_number_neighbors:
        return PlaneResiduals(np.zeros((0, 6)), np.zeros(0), num, False)
    return PlaneResiduals(np.asarray(rows_H), np.asarray(rows_h), num, True)


def angular_distance_deg(so3_vec: np.ndarray) -> float:
    return float(np.degrees(np.linalg.norm(so3_vec)))


def update_iekf(
    icp: IcpOptions,
    eskf: Eskf,
    vmap: VoxelMap,
    keypoints_loc: np.ndarray,
    last_t: np.ndarray,
    frame_id: int,
    init_num_frames: int = 20,
) -> bool:
    """optimize.cpp:136-306 — iterates ICP linearization around the ESKF."""
    max_iter = max(15, icp.num_iters_icp) if frame_id < init_num_frames else icp.num_iters_icp
    nb_voxels = 2 if frame_id < init_num_frames else icp.voxel_neighborhood
    threshold_cap = 1 if frame_id < init_num_frames else icp.threshold_voxel_occupancy

    p_pred, q_pred = eskf.p.copy(), eskf.q.copy()
    v_pred, ba_pred = eskf.v.copy(), eskf.ba.copy()
    bg_pred, g_pred = eskf.bg.copy(), eskf.g.copy()

    for i in range(-1, max_iter):
        res = build_plane_residuals(
            icp, vmap, keypoints_loc, eskf.q, eskf.p, last_t,
            nb_voxels, threshold_cap)
        if not res.success:
            return False

        H_x, h = res.H, res.h

        d_p = eskf.p - p_pred
        d_q = so3.quat_mul(so3.quat_conj(q_pred), eskf.q)
        d_so3 = so3.quat_to_so3(d_q)
        d_v = eskf.v - v_pred
        d_ba = eskf.ba - ba_pred
        d_bg = eskf.bg - bg_pred

        gp = g_pred / np.linalg.norm(g_pred)
        gc = eskf.g / np.linalg.norm(eskf.g)
        R_dg = so3.rot_between_unit_vectors(gp, gc)
        so3_dg = so3.rot_to_so3(R_dg)
        B_pred = so3.derivative_s2(g_pred)
        d_g = B_pred.T @ so3_dg

        d_x = np.concatenate([d_p, d_so3, d_v, d_ba, d_bg, d_g])

        J_so3 = np.eye(3) - 0.5 * so3.skew(d_so3)
        J_s2 = np.eye(2) + 0.5 * B_pred.T @ so3.skew(so3_dg) @ B_pred

        d_x_new = d_x.copy()
        d_x_new[3:6] = J_so3 @ d_so3
        d_x_new[15:17] = J_s2 @ d_g

        P = eskf.covariance.copy()
        P[3:6, :] = J_so3 @ P[3:6, :]
        P[15:17, :] = J_s2 @ P[15:17, :]
        P[:, 3:6] = P[:, 3:6] @ J_so3.T
        P[:, 15:17] = P[:, 15:17] @ J_s2.T

        temp = np.linalg.inv(P / LASER_POINT_COV)
        HTH = H_x.T @ H_x
        temp[0:6, 0:6] += HTH
        temp_inv = np.linalg.inv(temp)
        K_h = temp_inv[:, 0:6] @ (H_x.T @ h)
        K_x = np.zeros((17, 17))
        K_x[:, 0:6] = temp_inv[:, 0:6] @ HTH

        g_before = eskf.g.copy()
        d_x = -K_h + (K_x - np.eye(17)) @ d_x_new

        if np.linalg.norm(d_x[0:3]) > 100.0 or angular_distance_deg(d_x[3:6]) > 100.0:
            continue

        eskf.observe(d_x)

        converged = (
            frame_id > 1
            and np.linalg.norm(d_x[0:3]) < icp.threshold_translation_norm
            and angular_distance_deg(d_x[3:6]) < icp.threshold_orientation_norm
        )

        if converged or i == max_iter - 1:
            # final covariance downdate, replicating the reference's exact
            # update order (optimize.cpp:256-300): the column transform of
            # covariance_new uses the PRE-row-update covariance and clobbers
            # the row-updated intersection block.
            B_before = so3.derivative_s2(g_before)
            J_so3 = np.eye(3) - 0.5 * so3.skew(d_x[3:6])
            J_s2 = (np.eye(2) + 0.5 * B_before.T
                    @ so3.skew(B_before @ d_x[15:17]) @ B_before)

            P_old = P.copy()
            P_new = P_old.copy()
            P_new[3:6, :] = J_so3 @ P_old[3:6, :]
            P_new[15:17, :] = J_s2 @ P_old[15:17, :]
            P_new[:, 3:6] = P_old[:, 3:6] @ J_so3.T
            P_new[:, 15:17] = P_old[:, 15:17] @ J_s2.T
            P_mid = P_old.copy()
            P_mid[:, 3:6] = P_old[:, 3:6] @ J_so3.T
            P_mid[:, 15:17] = P_old[:, 15:17] @ J_s2.T

            K_x[3:6, 0:6] = J_so3 @ K_x[3:6, 0:6]
            K_x[15:17, 0:6] = J_s2 @ K_x[15:17, 0:6]
            eskf.covariance = P_new - K_x[:, 0:6] @ P_mid[0:6, :]
            return True

    return True


class SweepResult(NamedTuple):
    q_wxyz: np.ndarray
    t: np.ndarray
    points_world: np.ndarray
    success: bool


class Odometry:
    """The run/process loop (lioOptimization.cpp:2289-2478, 1319-1490)
    decoupled from ROS: feed IMU samples and motion-compensated-ready
    LiDAR sweeps; maintains the ESKF and the ICP voxel map."""

    def __init__(self, odom: OdometryOptions = OdometryOptions(),
                 icp: IcpOptions = IcpOptions(),
                 R_imu_lidar=np.eye(3), t_imu_lidar=np.zeros(3),
                 use_native: bool | None = None):
        self.odom = odom
        self.icp = icp
        self.eskf = Eskf()
        if use_native is None or use_native:
            from . import native
            if native.available():
                self.vmap = native.NativeVoxelMap(
                    icp.size_voxel_map, odom.max_num_points_in_voxel,
                    odom.min_distance_points)
            elif use_native:
                raise RuntimeError("native voxel map requested but unavailable")
            else:
                self.vmap = VoxelMap(icp.size_voxel_map,
                                     odom.max_num_points_in_voxel,
                                     odom.min_distance_points)
        else:
            self.vmap = VoxelMap(icp.size_voxel_map,
                                 odom.max_num_points_in_voxel,
                                 odom.min_distance_points)
        self.R_il = np.asarray(R_imu_lidar, np.float64)
        self.t_il = np.asarray(t_imu_lidar, np.float64)
        self.frame_id = 0
        self.last_t = np.zeros(3)
        self.poses: list[tuple[float, np.ndarray, np.ndarray]] = []
        self._imu_buffer: list[tuple[float, np.ndarray, np.ndarray]] = []
        self._last_imu_time: float | None = None
        # per-sweep IMU state trail for distortFrameByImu-style deskewing
        # (the reference's v_imu/imu_states list, lioOptimization.cpp:2398);
        # entry i+1 carries the (un_acc_world, un_gyr_body) that propagated
        # state i -> i+1. Reset each packet via begin_sweep_states().
        self.imu_states: list[tuple] = []

    def begin_sweep_states(self):
        """Seed the per-sweep IMU state trail with the current filter state
        (called at the start of each measurement packet). Before the first
        IMU sample there is no real timestamp to anchor the trail — seeding
        t0=0.0 would make dt = t_point - 0.0 (an absolute timestamp) in the
        IMU deskew and extrapolate catastrophically, so leave the trail
        empty; the driver then falls back to constant-velocity compensation
        (livo.py checks len >= 2). The reference seeds imu_states[0] with a
        real filter stamp (lioOptimization.cpp:2398)."""
        if self._last_imu_time is None:
            self.imu_states = []
            return
        self.imu_states = [(self._last_imu_time, self.eskf.q.copy(),
                            self.eskf.p.copy(), self.eskf.v.copy(),
                            np.zeros(3), np.zeros(3))]

    # ----- IMU path (run loop, 2289-2478) -----
    def add_imu(self, t: float, gyr, acc):
        gyr = np.asarray(gyr, np.float64)
        acc = np.asarray(acc, np.float64)
        if not self.eskf.initial_flag:
            self._imu_buffer.append((t, gyr, acc))
            self.eskf.try_init(self._imu_buffer[-1:])
            self._last_imu_time = t
            return
        dt = t - (self._last_imu_time if self._last_imu_time is not None else t)
        if dt > 0:
            # mid-point increments exactly as predict() uses them; recorded
            # for the IMU deskew path (utility.cpp:246-322 needs the
            # world-frame net acceleration and body angular rate per segment)
            un_gyr = 0.5 * (self.eskf.gyr_0 + gyr) - self.eskf.bg
            un_acc = (so3.quat_to_rot(self.eskf.q)
                      @ (0.5 * (self.eskf.acc_0 + acc) - self.eskf.ba)
                      - self.eskf.g)
            self.eskf.predict(dt, acc, gyr)
            if self.imu_states:
                self.imu_states.append(
                    (t, self.eskf.q.copy(), self.eskf.p.copy(),
                     self.eskf.v.copy(), un_acc, un_gyr))
        self._last_imu_time = t

    # ----- LiDAR sweep (process, 1319-1490) -----
    def add_sweep(self, t: float, points_lidar: np.ndarray) -> SweepResult:
        """points_lidar: [N,3] in the LiDAR frame, already motion-compensated
        to the sweep end (see motion_compensation helpers)."""
        self.frame_id += 1
        pts_loc = points_lidar @ self.R_il.T + self.t_il  # IMU frame

        sample_size = (self.odom.init_sample_voxel_size
                       if self.frame_id < self.odom.init_num_frames
                       else self.odom.sample_voxel_size)
        sub_size = (self.odom.init_voxel_size
                    if self.frame_id < self.odom.init_num_frames
                    else self.odom.voxel_size)

        if sub_size > 0:
            pts_loc = pts_loc[grid_sample(pts_loc, sub_size)]
        key_idx = grid_sample(pts_loc, sample_size)
        keypoints = pts_loc[key_idx]

        success = True
        if self.frame_id == 1:
            pass  # bootstrap: first sweep seeds the map at the current pose
        else:
            success = update_iekf(
                self.icp, self.eskf, self.vmap, keypoints, self.last_t,
                self.frame_id, self.odom.init_num_frames)

        R = so3.quat_to_rot(self.eskf.q)
        world = pts_loc @ R.T + self.eskf.p
        self.vmap.add_points(world)
        self.vmap.remove_far_voxels(self.eskf.p, self.odom.max_distance)

        self.last_t = self.eskf.p.copy()
        self.poses.append((t, self.eskf.q.copy(), self.eskf.p.copy()))
        return SweepResult(self.eskf.q.copy(), self.eskf.p.copy(), world,
                           success)


def _quat_rotate_rows(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate each row v[i] by unit quaternion q[i] (wxyz): v + 2w(u x v)
    + 2 u x (u x v). Vectorized over rows."""
    w = q[:, :1]
    u = q[:, 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_mul_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise Hamilton product (wxyz), a [N,4] x b [N,4]."""
    aw, ax, ay, az = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    bw, bx, by, bz = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], axis=1)


def _so3_to_quat_rows(r: np.ndarray) -> np.ndarray:
    """Row-wise exp map to quaternion with the small-angle branch
    (utility.h so3ToQuat semantics, vectorized)."""
    theta = np.linalg.norm(r, axis=1, keepdims=True)
    small = theta[:, 0] < so3.THETA_THRESHOLD
    # small-angle: normalize([1, r/2])
    q_small = np.concatenate([np.ones((len(r), 1)), 0.5 * r], axis=1)
    q_small /= np.linalg.norm(q_small, axis=1, keepdims=True)
    safe = np.where(theta > 0, theta, 1.0)
    axis = r / safe
    q_big = np.concatenate(
        [np.cos(theta / 2), np.sin(theta / 2) * axis], axis=1)
    return np.where(small[:, None], q_small, q_big)


def motion_compensate_imu(
    points_lidar: np.ndarray,
    rel_time_s: np.ndarray,
    imu_states: list,  # [(t, q_wxyz, trans, vel, un_acc, un_gyr), ...]
    t_frame_begin: float,
    q_end, t_end, R_il, t_il,
) -> np.ndarray:
    """distortFrameByImu (utility.cpp:246-322): piecewise-IMU-state
    deskewing — each point is placed with the pose integrated from its
    bracketing IMU interval (quat_imu * exp(un_gyr dt), trans + v dt +
    0.5 a dt^2), then re-expressed in the end-of-sweep LiDAR frame.
    Fully vectorized over points (the reference's per-point loop is CPU
    real-time budget; a 20k-point sweep must deskew in well under the
    100 ms sweep interval)."""
    points_lidar = np.asarray(points_lidar, np.float64)
    R_il = np.asarray(R_il, np.float64)
    t_il = np.asarray(t_il, np.float64)
    t_end = np.asarray(t_end, np.float64)
    R_end = so3.quat_to_rot(q_end)
    times = t_frame_begin + np.asarray(rel_time_s, np.float64)
    M = len(imu_states)

    T = np.asarray([s[0] for s in imu_states], np.float64)
    Q = np.stack([np.asarray(s[1], np.float64) for s in imu_states])
    TR = np.stack([np.asarray(s[2], np.float64) for s in imu_states])
    V = np.stack([np.asarray(s[3], np.float64) for s in imu_states])
    UA = np.stack([np.asarray(s[4], np.float64) for s in imu_states])
    UG = np.stack([np.asarray(s[5], np.float64) for s in imu_states])

    # bracketing segment per point: the largest s <= M-2 with
    # tp >= T[j] - 1e-6 for all j <= s (the reference's advance-while loop)
    seg = np.searchsorted(T[1:M - 1], times + 1e-6, side="right") \
        if M > 2 else np.zeros(len(times), np.int64)

    dt = np.maximum(times - T[seg], 0.0)[:, None]
    qp = _quat_mul_rows(Q[seg], _so3_to_quat_rows(UG[seg + 1] * dt))
    trp = TR[seg] + V[seg] * dt + 0.5 * UA[seg + 1] * dt * dt
    world = _quat_rotate_rows(qp, points_lidar @ R_il.T + t_il) + trp
    imu_end = (world - t_end) @ R_end
    return (imu_end - t_il) @ R_il


def motion_compensate_constant(
    points_lidar: np.ndarray,
    rel_time_s: np.ndarray,
    q_begin, t_begin, q_end, t_end,
    R_il, t_il,
    duration_s: float | None = None,
) -> np.ndarray:
    """distortFrameByConstant (utility.cpp:204-244): per-point slerp pose,
    transform to world, then re-express in the END-of-sweep LiDAR frame.
    duration_s is the begin->end pose interval (the reference uses the IMU
    window, utility.cpp:212); defaults to the max point time. Vectorized
    over points (Eigen slerp semantics, including the near-parallel nlerp
    branch)."""
    points_lidar = np.asarray(points_lidar, np.float64)
    duration = duration_s if duration_s else max(rel_time_s.max(), 1e-9)
    a = np.clip(np.asarray(rel_time_s, np.float64) / duration,
                0.0, 1.0)[:, None]
    R_il = np.asarray(R_il, np.float64)
    t_il = np.asarray(t_il, np.float64)
    t_begin = np.asarray(t_begin, np.float64)
    t_end = np.asarray(t_end, np.float64)
    R_end = so3.quat_to_rot(q_end)

    q0 = so3.quat_normalize(np.asarray(q_begin, np.float64))
    q1 = so3.quat_normalize(np.asarray(q_end, np.float64))
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 1 - 1e-10:  # near-parallel: Eigen's nlerp branch
        qa = (1 - a) * q0 + a * q1
        qa /= np.linalg.norm(qa, axis=1, keepdims=True)
    else:
        theta = np.arccos(d)
        qa = (np.sin((1 - a) * theta) * q0 + np.sin(a * theta) * q1) \
            / np.sin(theta)
    ta = (1 - a) * t_begin + a * t_end
    world = _quat_rotate_rows(qa, points_lidar @ R_il.T + t_il) + ta
    imu_end = (world - t_end) @ R_end
    return (imu_end - t_il) @ R_il
