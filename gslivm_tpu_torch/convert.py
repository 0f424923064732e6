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
from .models.gaussian_model import GaussianParams
from .models.training import SimiInputs
from .utils.device import resolve_device

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "n_active")
CAMERA_TENSOR_FIELDS = ("R_cw", "t_cw", "fx", "fy", "tan_fovx", "tan_fovy",
                        "cam_center", "K")


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
