"""Debug tensor IO for offline numerical comparison (the port's own copy of
gslivm_tpu/utils/debug.py; it takes torch tensors as well as arrays).

Analog of the reference's `include/gs/gs/debug_utils.cuh`
(ts::save_my_tensor / load_my_tensor: raw tensor dumps for diffing against
another implementation) and `saveDepthMapAsNPY` (lioOptimization.cpp:
2138-2148, via cnpy). Uses .npy as the container so dumps are readable from
any numpy/torch environment — including one running the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(array) -> np.ndarray:
    if torch.is_tensor(array):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def save_tensor(path: str, array) -> None:
    """Dump a tensor (any device) or array as .npy for offline diffing."""
    arr = _host(array)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, arr)


def load_tensor(path: str) -> np.ndarray:
    return np.load(path)


def compare_dumps(path_a: str, path_b: str, atol=1e-5, rtol=1e-4) -> dict:
    """Numerical diff report between two dumps (the ts:: diff workflow)."""
    a, b = np.load(path_a), np.load(path_b)
    if a.shape != b.shape:
        return {"match": False, "reason": f"shape {a.shape} vs {b.shape}"}
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    denom = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    rel = diff / np.where(denom > 0, denom, 1.0)
    ok = bool(np.all(diff <= atol + rtol * denom))
    return {
        "match": ok,
        "max_abs": float(diff.max()) if diff.size else 0.0,
        "max_rel": float(rel.max()) if rel.size else 0.0,
        "mean_abs": float(diff.mean()) if diff.size else 0.0,
    }
