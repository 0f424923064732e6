"""Carry state over from the JAX package, as numpy arrays, with no numeric
change: the same map and cameras can then be rendered by both packages.

The arrays come from the JAX package's `GaussianParams` / `Camera` fields
(e.g. `{f: np.asarray(getattr(params, f)) for f in PARAM_FIELDS}`); this
module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.cameras import Camera
from .models.gaussian_model import GaussianParams, HashIndexRegistry
from .models.training import SimiInputs
from .ops.gp3d import CameraProjection
from .utils.device import resolve_device

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "n_active")
CAMERA_TENSOR_FIELDS = ("R_cw", "t_cw", "fx", "fy", "tan_fovx", "tan_fovy",
                        "cam_center", "K")
PROJECTION_FIELDS = ("R_wc", "t_wc", "fx", "fy", "cx", "cy", "dist")


def _tensor(a, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def params_from_numpy(d, device="cuda") -> GaussianParams:
    """A mapping of PARAM_FIELDS -> numpy arrays -> the port's GaussianParams."""
    dev = resolve_device(device)
    return GaussianParams(
        **{f: _tensor(d[f], dev) for f in PARAM_FIELDS if f != "n_active"},
        n_active=int(np.asarray(d["n_active"])))


def camera_from_numpy(d, device="cuda") -> Camera:
    """A mapping of the camera fields (the tensors plus int width/height)
    -> the port's Camera."""
    dev = resolve_device(device)
    return Camera(**{f: _tensor(d[f], dev) for f in CAMERA_TENSOR_FIELDS},
                  width=int(d["width"]), height=int(d["height"]))


def inst_from_numpy(feature_major, device="cuda") -> torch.Tensor:
    """A feature-major [16, L] instance table (the JAX kernels' layout) ->
    the port's row-major [L, 16] float32 table, contiguous on `device`."""
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(feature_major, dtype=np.float32).T)).to(dev)


def simi_from_numpy(d, device="cuda") -> SimiInputs:
    """A mapping of the SimiInputs fields -> numpy arrays (anchor points,
    their mask, gaussian indices, their mask) -> the port's SimiInputs."""
    dev = resolve_device(device)
    return SimiInputs(
        points=_tensor(d["points"], dev),
        point_mask=torch.from_numpy(np.array(d["point_mask"], dtype=bool)).to(dev),
        gauss_idx=torch.from_numpy(np.array(d["gauss_idx"], dtype=np.int32)).to(dev),
        gauss_mask=torch.from_numpy(np.array(d["gauss_mask"], dtype=bool)).to(dev))


def cam_projection_from_numpy(d, device="cuda") -> CameraProjection:
    """A mapping of the CameraProjection fields -> numpy arrays -> the
    port's CameraProjection (colorization)."""
    dev = resolve_device(device)
    return CameraProjection(**{f: _tensor(d[f], dev) for f in PROJECTION_FIELDS})


def registry_from_ranges(d) -> HashIndexRegistry:
    """A mapping voxel hash -> list of (start, count) index ranges (the JAX
    HashIndexRegistry's `_ranges`) -> the port's registry."""
    reg = HashIndexRegistry()
    for h, ranges in d.items():
        for start, count in ranges:
            reg.append_range(int(h), int(start), int(count))
    return reg


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: GaussianParams, d):
    """Carry optax Adam state into the port's optimizer (from
    training.make_optimizer over `params`).

    d maps each group name (a parameter field) to {"mu", "nu", "count"}:
    that group's first and second moments as numpy arrays and its step
    count, as the JAX optimizer holds them in
    `opt_state.inner_states[name].inner_state[0]` (mu/nu are GaussianParams
    there; pass the field's array). They become `exp_avg`, `exp_avg_sq` and
    `step`. Returns the optimizer."""
    dev = params.xyz.device
    for group in optimizer.param_groups:
        (p,) = group["params"]
        st = d[group["name"]]
        if p is not getattr(params, group["name"]):
            raise ValueError(f"group {group['name']!r} does not hold the module's parameter")
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(st["count"])), dtype=torch.float32),
            "exp_avg": _tensor(st["mu"], dev).reshape(p.shape),
            "exp_avg_sq": _tensor(st["nu"], dev).reshape(p.shape),
        }
    return optimizer
