"""Extrinsic calibration arithmetic (the port's own copy of
gslivm_tpu/tools/calib.py: python/calc_extrinsic.py:1-19, calc_det.py:1-8
behavioral parity).

The reference configs store three SE(3) extrinsics — T_il (IMU<-LiDAR),
T_cl (camera<-LiDAR), T_ic (IMU<-camera) — and the calc_extrinsic tool
derives the missing one: T_ic = T_il @ inv(T_cl).
"""

from __future__ import annotations

import argparse

import numpy as np


def se3(R=None, t=None) -> np.ndarray:
    """Assemble a 4x4 homogeneous transform from a 3x3 R and/or 3-vector t."""
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = np.asarray(R, np.float64).reshape(3, 3)
    if t is not None:
        T[:3, 3] = np.asarray(t, np.float64).reshape(3)
    return T


def inv_se3(T: np.ndarray) -> np.ndarray:
    """Closed-form SE(3) inverse (no general 4x4 inversion needed)."""
    R = T[:3, :3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def compose_tic(til: np.ndarray, tcl: np.ndarray) -> np.ndarray:
    """T_ic = T_il @ inv(T_cl) (calc_extrinsic.py:17)."""
    return np.asarray(til) @ inv_se3(np.asarray(tcl))


def matrix_report(mat: np.ndarray) -> dict:
    """Determinant + inverse of an arbitrary square matrix
    (calc_det.py usage: sanity-check projection/extrinsic matrices)."""
    mat = np.asarray(mat, np.float64)
    return {"det": float(np.linalg.det(mat)), "inv": np.linalg.inv(mat)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--til-r", type=float, nargs=9, required=True,
                    help="row-major 3x3 rotation of T_il")
    ap.add_argument("--til-t", type=float, nargs=3, required=True)
    ap.add_argument("--tcl-r", type=float, nargs=9, required=True)
    ap.add_argument("--tcl-t", type=float, nargs=3, required=True)
    args = ap.parse_args(argv)
    tic = compose_tic(se3(args.til_r, args.til_t),
                      se3(args.tcl_r, args.tcl_t))
    print("T_ic rotation (row-major):", tic[:3, :3].reshape(-1).tolist())
    print("T_ic translation:", tic[:3, 3].tolist())


if __name__ == "__main__":
    main()
