"""Trajectory evaluation: TUM pose files, ATE/RPE metrics.
(the port's own copy of gslivm_tpu/utils/trajectory.py; numpy on the host, as there)

Tooling analog of the reference's `python/verbose_traj.py` /
`python/parse_pose.py` offline trajectory scripts: read the TUM-format
pose.txt the pipeline writes (utils/outputs.append_tum_pose), associate
two trajectories by timestamp, and compute absolute trajectory error with
Umeyama SE(3) alignment plus relative pose error.
"""

from __future__ import annotations

import numpy as np


def load_tum(path: str):
    """[(t, xyz[3], quat_xyzw[4])] from a TUM file -> (t [N], pos [N,3],
    quat [N,4])."""
    data = np.loadtxt(path).reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def associate(t_a, t_b, max_dt: float = 0.02):
    """Nearest-timestamp association; returns index pairs."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        j = int(np.searchsorted(t_b, t))
        cands = [k for k in (j - 1, j) if 0 <= k < len(t_b)]
        if not cands:
            continue
        k = min(cands, key=lambda k: abs(t_b[k] - t))
        if abs(t_b[k] - t) <= max_dt:
            ia.append(i)
            ib.append(k)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=False):
    """SE(3) (optionally Sim(3)) alignment dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / (xs**2).sum() * len(src)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos, gt_pos, align: bool = True) -> float:
    """Absolute trajectory error RMSE after (optional) SE(3) alignment."""
    est, gt = np.asarray(est_pos, float), np.asarray(gt_pos, float)
    if align and len(est) >= 3:
        s, R, t = umeyama_alignment(est, gt)
        est = est @ R.T * s + t
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def rpe_rmse(est_pos, gt_pos, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over frame gaps of `delta`."""
    est, gt = np.asarray(est_pos, float), np.asarray(gt_pos, float)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    return float(np.sqrt(((de - dg) ** 2).sum(axis=1).mean()))


def evaluate_tum_files(est_path: str, gt_path: str, max_dt: float = 0.02) -> dict:
    t_e, p_e, _ = load_tum(est_path)
    t_g, p_g, _ = load_tum(gt_path)
    ia, ib = associate(t_e, t_g, max_dt)
    if len(ia) < 3:
        return {"matched": int(len(ia)), "ate_rmse": float("nan")}
    return {
        "matched": int(len(ia)),
        "ate_rmse": ate_rmse(p_e[ia], p_g[ib]),
        "rpe_rmse": rpe_rmse(p_e[ia], p_g[ib]),
    }
