"""17-dim error-state Kalman filter for IMU propagation.
(the port's own copy of gslivm_tpu/frontend/eskf.py; numpy on the host, as there)

Behavioral spec: reference `src/liw/eskfEstimator.cpp` — error state
[dp(3), dtheta(3), dv(3), dba(3), dbg(3), dg(2 on S^2)], 12-dim process
noise (acc, gyr, bias walks):

  - static initialization (tryInit:38-109): running mean/var of >=
    MIN_INI_COUNT=20 samples over >= MIN_INI_TIME=0.2 s; gravity from the
    mean accelerometer direction, gyro bias from the mean rate; variance
    sanity gates MAX_GYR_VAR=0.5 / MAX_ACC_VAR=0.6 (utility.h:28-31);
    post-init covariance shrinks for v/b/g blocks (tryInit:70-72).
  - mid-point predict (predict:187-238) with F_x/F_w exactly as the
    reference builds them (including the S^2 gravity Jacobian via
    derivativeS2).
  - observe (240-250): error-state injection.
  - observePose (252-282): 6-dof pose update used by the VIO path.

Runs in numpy float64 — this is host-side, latency-bound sequential
filtering (SURVEY §7 design posture).
"""

from __future__ import annotations

import numpy as np

from . import so3

MIN_INI_COUNT = 20
MIN_INI_TIME = 0.2
MAX_GYR_VAR = 0.5
MAX_ACC_VAR = 0.6


class Eskf:
    def __init__(self):
        self.p = np.zeros(3)
        self.q = np.array([1.0, 0, 0, 0])
        self.v = np.zeros(3)
        self.ba = np.zeros(3)
        self.bg = np.zeros(3)
        self.g = np.array([0.0, 0.0, 9.81])
        self.covariance = np.eye(17)
        self.noise = np.zeros((12, 12))

        self.acc_cov_scale = np.full(3, 0.1)
        self.gyr_cov_scale = np.full(3, 0.1)
        self.b_acc_cov = np.full(3, 1e-4)
        self.b_gyr_cov = np.full(3, 1e-5)

        self.mean_gyr = np.zeros(3)
        self.mean_acc = np.array([0.0, 0.0, 9.81])
        self.gyr_cov = np.zeros(3)
        self.acc_cov = np.zeros(3)
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        self.is_first_imu = True
        self.num_init = 1
        self.time_first_imu = 0.0
        self.initial_flag = False
        self.g_norm = 9.81

    # ---------------- initialization (tryInit / initialization) ----------

    def try_init(self, imu_meas: list[tuple[float, np.ndarray, np.ndarray]]):
        """imu_meas: [(t, gyr, acc), ...]. Returns True once initialized."""
        self._accumulate(imu_meas)
        if (self.num_init > MIN_INI_COUNT
                and imu_meas[-1][0] - self.time_first_imu > MIN_INI_TIME):
            if np.linalg.norm(self.gyr_cov) > MAX_GYR_VAR:
                return False
            if np.linalg.norm(self.acc_cov) > MAX_ACC_VAR:
                return False
            self.initial_flag = True
            self.bg = self.mean_gyr.copy()
            self.g = self.mean_acc / np.linalg.norm(self.mean_acc) * self.g_norm
            self.covariance[9:12, 9:12] *= 0.001
            self.covariance[12:15, 12:15] *= 0.0001
            self.covariance[15:17, 15:17] *= 0.00001
            self.noise[0:3, 0:3] = np.diag(self.acc_cov_scale)
            self.noise[3:6, 3:6] = np.diag(self.gyr_cov_scale)
            self.noise[6:9, 6:9] = np.diag(self.b_acc_cov)
            self.noise[9:12, 9:12] = np.diag(self.b_gyr_cov)
            return True
        return False

    def _accumulate(self, imu_meas):
        if self.is_first_imu:
            self.num_init = 1
            self.is_first_imu = False
            self.time_first_imu = imu_meas[0][0]
            self.mean_gyr = np.asarray(imu_meas[0][1], np.float64).copy()
            self.mean_acc = np.asarray(imu_meas[0][2], np.float64).copy()
        for _, gyr, acc in imu_meas:
            gyr = np.asarray(gyr, np.float64)
            acc = np.asarray(acc, np.float64)
            n = self.num_init
            self.mean_gyr += (gyr - self.mean_gyr) / n
            self.mean_acc += (acc - self.mean_acc) / n
            self.gyr_cov = (self.gyr_cov * (n - 1.0) / n
                            + (gyr - self.mean_gyr) ** 2 * (n - 1.0) / (n * n))
            self.acc_cov = (self.acc_cov * (n - 1.0) / n
                            + (acc - self.mean_acc) ** 2 * (n - 1.0) / (n * n))
            self.num_init += 1
        self.gyr_0 = np.asarray(imu_meas[-1][1], np.float64)
        self.acc_0 = np.asarray(imu_meas[-1][2], np.float64)

    # ---------------- predict (eskfEstimator.cpp:187-238) -----------------

    def predict(self, dt: float, acc_1, gyr_1):
        acc_1 = np.asarray(acc_1, np.float64)
        gyr_1 = np.asarray(gyr_1, np.float64)
        q_before = self.q.copy()
        un_gyr = 0.5 * (self.gyr_0 + gyr_1) - self.bg
        un_acc = 0.5 * (self.acc_0 + acc_1) - self.ba
        self.q = so3.quat_mul(self.q, so3.so3_to_quat(un_gyr * dt))
        self.p = self.p + self.v * dt
        R_before = so3.quat_to_rot(q_before)
        self.v = self.v + R_before @ un_acc * dt - self.g * dt

        Rw = so3.skew(un_gyr)
        Ra = so3.skew(un_acc)
        B = so3.derivative_s2(self.g)
        gn2 = float(self.g @ self.g)

        F_x = np.zeros((17, 17))
        F_x[0:3, 0:3] = np.eye(3)
        F_x[0:3, 6:9] = np.eye(3) * dt
        F_x[3:6, 3:6] = np.eye(3) - Rw * dt
        F_x[3:6, 12:15] = -np.eye(3) * dt
        F_x[6:9, 3:6] = -R_before @ Ra * dt
        F_x[6:9, 6:9] = np.eye(3)
        F_x[6:9, 9:12] = -R_before * dt
        F_x[6:9, 15:17] = so3.skew(self.g) @ B * dt
        F_x[9:12, 9:12] = np.eye(3)
        F_x[12:15, 12:15] = np.eye(3)
        F_x[15:17, 15:17] = (-1.0 / gn2) * B.T @ so3.skew(self.g) @ so3.skew(self.g) @ B

        F_w = np.zeros((17, 12))
        F_w[6:9, 0:3] = -R_before * dt
        F_w[3:6, 3:6] = -np.eye(3) * dt
        F_w[9:12, 6:9] = -np.eye(3) * dt
        F_w[12:15, 9:12] = -np.eye(3) * dt

        self.covariance = F_x @ self.covariance @ F_x.T + F_w @ self.noise @ F_w.T
        self.acc_0 = acc_1
        self.gyr_0 = gyr_1

    # ---------------- observe (240-250) -----------------------------------

    def observe(self, d_x):
        d_x = np.asarray(d_x, np.float64)
        self.p = self.p + d_x[0:3]
        self.q = so3.quat_normalize(so3.quat_mul(self.q, so3.so3_to_quat(d_x[3:6])))
        self.v = self.v + d_x[6:9]
        self.ba = self.ba + d_x[9:12]
        self.bg = self.bg + d_x[12:15]
        B = so3.derivative_s2(self.g)
        so3_dg = B @ d_x[15:17]
        self.g = so3.so3_to_rot(so3_dg) @ self.g

    # ---------------- observePose (252-282) --------------------------------

    def observe_pose(self, translation, quat_wxyz, trans_noise: float,
                     ang_noise: float):
        H = np.zeros((6, 17))
        H[0:3, 0:3] = np.eye(3)
        H[3:6, 3:6] = so3.inv_jright_so3(so3.quat_to_so3(self.q))
        V = np.diag([trans_noise] * 3 + [ang_noise] * 3)
        P = self.covariance
        K = P @ H.T @ np.linalg.inv(H @ P @ H.T + V)

        dq = so3.quat_mul(so3.quat_conj(self.q), np.asarray(quat_wxyz, np.float64))
        update = np.concatenate([np.asarray(translation) - self.p,
                                 so3.quat_to_so3(dq)])
        delta = K @ update
        self.covariance = (np.eye(17) - K @ H) @ P
        # updateAndReset (284-299): inject + tangent update of g + projection
        self.p = self.p + delta[0:3]
        self.q = so3.quat_mul(self.q, so3.so3_to_quat(delta[3:6]))
        self.v = self.v + delta[6:9]
        self.ba = self.ba + delta[9:12]
        self.bg = self.bg + delta[12:15]
        self.g = self.g + self._lxly() @ delta[15:17]
        J = np.eye(17)
        J[3:6, 3:6] = np.eye(3) - 0.5 * so3.skew(delta[3:6])
        self.covariance = J @ self.covariance @ J.T

    def _lxly(self):
        """calculateLxly (301-316): orthonormal tangent basis at g."""
        a = self.g / np.linalg.norm(self.g)
        temp = np.array([0.0, 0.0, 1.0])
        if np.allclose(a, temp):
            temp = np.array([1.0, 0.0, 0.0])
        b = temp - a * (a @ temp)
        b = b / np.linalg.norm(b)
        c = np.cross(a, b)
        return np.stack([b, c], axis=1)
