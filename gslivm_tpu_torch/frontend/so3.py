"""SO(3) / S^2 math for the state-estimation front-end (numpy, float64).
(the port's own copy of gslivm_tpu/frontend/so3.py; numpy on the host, as there)

Behavioral spec: reference `include/liw/utility.h:165-368` (numType):
skewSymmetric, so3<->quat/rotation exponentials with small-angle branches at
THETA_THRESHOLD, invJrightSo3, derivativeS2 (the 3x2 tangent basis of the
gravity sphere used by the 17-dim ESKF's 2-dof gravity parameterization).

Quaternions are [w, x, y, z] numpy arrays.
"""

from __future__ import annotations

import numpy as np

THETA_THRESHOLD = 1e-7  # utility.h:26 (#define THETA_THRESHOLD 0.0000001)


def skew(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_normalize(q):
    return q / np.linalg.norm(q)


def quat_to_rot(q):
    w, x, y, z = quat_normalize(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def so3_to_quat(so3):
    """utility.h so3ToQuat with the small-angle branch."""
    theta = np.linalg.norm(so3)
    if theta < THETA_THRESHOLD:
        return quat_normalize(np.array([1.0, *(0.5 * so3)]))
    axis = so3 / theta
    return np.array([np.cos(theta / 2), *(np.sin(theta / 2) * axis)])


def so3_to_rot(so3):
    theta = np.linalg.norm(so3)
    if theta < THETA_THRESHOLD:
        ux = skew(so3)
        return np.eye(3) + ux + 0.5 * ux @ ux
    ux = skew(so3 / theta)
    return np.eye(3) + np.sin(theta) * ux + (1 - np.cos(theta)) * ux @ ux


def rot_to_so3(R):
    """Log map; matches utility.h rotationToSo3."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < THETA_THRESHOLD:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    if np.pi - theta < 1e-6:  # near-pi fallback
        A = 0.5 * (R + np.eye(3))
        axis = np.sqrt(np.clip(np.diag(A), 0, None))
        idx = int(np.argmax(axis))
        v = A[:, idx] / max(axis[idx], 1e-12)
        v = v / np.linalg.norm(v)
        return theta * v
    return (
        theta / (2 * np.sin(theta))
        * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    )


def quat_to_so3(q):
    return rot_to_so3(quat_to_rot(q))


def quat_slerp(q0, q1, alpha):
    """Eigen Quaterniond::slerp semantics."""
    q0 = quat_normalize(np.asarray(q0, np.float64))
    q1 = quat_normalize(np.asarray(q1, np.float64))
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 1 - 1e-10:
        return quat_normalize((1 - alpha) * q0 + alpha * q1)
    theta = np.arccos(d)
    return (np.sin((1 - alpha) * theta) * q0 + np.sin(alpha * theta) * q1) / np.sin(theta)


def inv_jright_so3(so3):
    """utility.h:187-201 invJrightSo3."""
    theta = np.linalg.norm(so3)
    if theta < THETA_THRESHOLD:
        return (np.cos(theta / 2) * np.eye(3)
                + 0.125 * np.outer(so3, so3) + 0.5 * skew(so3))
    u = so3 / theta
    half_cot = 0.5 * theta / np.tan(theta / 2)
    return (half_cot * np.eye(3) + (1 - half_cot) * np.outer(u, u)
            + 0.5 * skew(so3))


def derivative_s2(g):
    """utility.h derivativeS2: 3x2 tangent basis at gravity direction g.

    NOTE the reference's closed form assumes g normalized with 1 + g_z != 0
    (it divides by 1 + g(2)); we reproduce it exactly.
    """
    gn = np.asarray(g, np.float64)
    gn = gn / np.linalg.norm(gn)
    B = np.zeros((3, 2))
    B[0, 0] = 1.0 - gn[0] * gn[0] / (1.0 + gn[2])
    B[0, 1] = -gn[0] * gn[1] / (1.0 + gn[2])
    B[1, 0] = B[0, 1]
    B[1, 1] = 1.0 - gn[1] * gn[1] / (1.0 + gn[2])
    B[2, 0] = -gn[0]
    B[2, 1] = -gn[1]
    return B


def rot_between_unit_vectors(a, b):
    """Rotation taking unit vector a to unit vector b (optimize.cpp:186-199)."""
    cross = np.cross(a, b)
    dot = float(np.dot(a, b))
    if abs(1.0 - dot) < 1e-6:
        return np.eye(3)
    sk = skew(cross)
    return np.eye(3) + sk + sk @ sk * (1.0 - dot) / float(cross @ cross)
