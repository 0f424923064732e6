"""ctypes loaders for the port's host C++: the voxel map
(`native/voxel_map.cpp`; the port's own copy of
gslivm_tpu/frontend/native.py) and the camera intake's entropy coding
(`gslivm_tpu_torch/csrc/jpeg_entropy.cpp`, `codec()`).

Builds each shared library on demand with g++ and the JAX package's flags
(plain C ABI + ctypes; no pybind11), and exposes `NativeVoxelMap` with the
same API as the numpy `frontend.voxelmap.VoxelMap` so the odometry can swap
it in. Where the JAX loader writes its library next to the source, the
port writes into its own `gslivm_tpu_torch/build/` (never into `native/`),
under a name that hashes the source and the flags, as `kernels.py` names
its CUDA libraries: an edited source or flag rebuilds it. `available()` is
False when no compiler can build the voxel map; the intake has no other
decoder, so `codec()` raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "voxel_map.cpp"
CODEC_SRC = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_entropy.cpp"
BUILD = Path(__file__).resolve().parents[1] / "build"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_LIB = None
_TRIED = False
_CODEC = None
_LOCK = threading.Lock()


def library_path(src: Path = SRC, stem: str = "libgslivm_native") -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"{stem}-{h.hexdigest()[:12]}.so"


def _build(src: Path = SRC, stem: str = "libgslivm_native") -> Path | None:
    if not src.exists():
        return None
    out = library_path(src, stem)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        d = ctypes.c_double
        p = ctypes.c_void_p
        dp = ctypes.POINTER(ctypes.c_double)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.vmap_create.restype = p
        lib.vmap_create.argtypes = [d, ctypes.c_int, d]
        lib.vmap_destroy.argtypes = [p]
        lib.vmap_size.restype = ctypes.c_long
        lib.vmap_size.argtypes = [p]
        lib.vmap_add_points.argtypes = [p, dp, ctypes.c_long, ctypes.c_int]
        lib.vmap_remove_far.argtypes = [p, dp, d]
        lib.vmap_knn.argtypes = [p, dp, ctypes.c_long, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, dp, lp]
        lib.vmap_build_plane_residuals.restype = ctypes.c_long
        lib.vmap_build_plane_residuals.argtypes = [
            p, dp, ctypes.c_long, dp, dp, dp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, d, d, d, d, ctypes.c_long, dp, dp]
        _LIB = lib
        return lib


def available() -> bool:
    return _load() is not None


def codec():
    """The loaded `csrc/jpeg_entropy.cpp` (jpeg_decode_scan,
    jpeg_encode_scan, png_unfilter); raises when g++ cannot build it."""
    global _CODEC
    with _LOCK:
        if _CODEC is not None:
            return _CODEC
        path = _build(CODEC_SRC, "libgslivm_codec")
        if path is None:
            raise RuntimeError(f"g++ could not build {CODEC_SRC}")
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i, lg = ctypes.c_int, ctypes.c_long
        lib.jpeg_decode_scan.restype = lg
        lib.jpeg_decode_scan.argtypes = [p, lg, i, p, i, i, i, p, p, p]
        lib.jpeg_encode_scan.restype = lg
        lib.jpeg_encode_scan.argtypes = [p, i, p, i, i, p, p, p, lg]
        lib.png_unfilter.restype = i
        lib.png_unfilter.argtypes = [p, lg, lg, i, p]
        _CODEC = lib
        return lib


def _as_dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeVoxelMap:
    """Drop-in twin of frontend.voxelmap.VoxelMap backed by C++."""

    def __init__(self, voxel_size: float, max_points: int = 20,
                 min_distance: float = 0.1):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.vmap_create(voxel_size, max_points, min_distance)
        self.size = voxel_size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vmap_destroy(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.vmap_size(self._h))

    def add_points(self, points: np.ndarray, min_num_points: int = 0):
        pts = np.ascontiguousarray(points, np.float64)
        self._lib.vmap_add_points(self._h, _as_dp(pts), len(pts),
                                  min_num_points)

    def remove_far_voxels(self, center: np.ndarray, max_distance: float):
        c = np.ascontiguousarray(center, np.float64)
        self._lib.vmap_remove_far(self._h, _as_dp(c), max_distance)

    def search_neighbors(self, point: np.ndarray, nb_voxels: int,
                         max_neighbors: int, threshold_capacity: int = 1):
        q = np.ascontiguousarray(point, np.float64).reshape(1, 3)
        out = np.zeros((1, max_neighbors, 3), np.float64)
        counts = np.zeros(1, np.int64)
        self._lib.vmap_knn(self._h, _as_dp(q), 1, nb_voxels, max_neighbors,
                           threshold_capacity, _as_dp(out),
                           counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        return out[0, :int(counts[0])]

    def build_plane_residuals(self, keypoints_loc, R, t, last_t, nb_voxels,
                              threshold_capacity, max_neighbors,
                              min_neighbors, power_planarity, max_dist,
                              w_alpha, w_neigh, max_residuals):
        kp = np.ascontiguousarray(keypoints_loc, np.float64)
        Rm = np.ascontiguousarray(R, np.float64)
        tv = np.ascontiguousarray(t, np.float64)
        lt = np.ascontiguousarray(last_t, np.float64)
        H = np.zeros((max_residuals, 6), np.float64)
        h = np.zeros(max_residuals, np.float64)
        n = self._lib.vmap_build_plane_residuals(
            self._h, _as_dp(kp), len(kp), _as_dp(Rm), _as_dp(tv), _as_dp(lt),
            nb_voxels, threshold_capacity, max_neighbors, min_neighbors,
            power_planarity, max_dist, w_alpha, w_neigh, max_residuals,
            _as_dp(H), _as_dp(h))
        return H[:n], h[:n]
