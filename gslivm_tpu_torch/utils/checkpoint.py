"""Checkpoint / resume for long mapping runs (port of
gslivm_tpu/utils/checkpoint.py).

The reference has NO resume path — outputs only (SURVEY §5): PLY map, PCD
cloud, TUM poses. This module adds true checkpoint/resume: device state
(the GaussianParams and the Adam state) through `torch.save` into
`device.pt`, host state (voxel cells, hash registry, cameras, loss anchors,
the deferred-colour pool) as the JAX package's pickle sidecar `host.pkl`,
with the same keys. `save_mapper` / `load_mapper` round-trip the whole
IncrementalMapper.

Resume keeps Adam keyed to the mapper's own Parameters: the fresh mapper
grows in place to the saved capacity first, then the values, `exp_avg`,
`exp_avg_sq` and `step` are copied in. As in the JAX package, the camera
sampler's rng, its visited sets and the refitted tile budgets are not
saved, so a resumed run draws other cameras than the run it continues.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from ..frontend.gpmap import _Cell
from ..models import gaussian_model as gm
from ..models import training
from ..models.cameras import Camera
from ..ops import losses as loss_ops

DEVICE_FILE = "device.pt"
HOST_FILE = "host.pkl"
_TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(Camera)
                       if f.name not in ("width", "height"))


def _device_state(mapper) -> dict:
    """Parameters (and n_active) by name, and per Adam group its moments
    and step (a group's lr follows from the config and its step)."""
    opt = mapper.optimizer
    adam = {g["name"]: dict(opt.state.get(g["params"][0], {})) for g in opt.param_groups}
    return {"params": dict(mapper.params.state_dict()), "adam": adam}


def _camera_to_host(cam: Camera) -> Camera:
    return dataclasses.replace(cam, **{f: getattr(cam, f).detach().cpu().numpy()
                                       for f in _TENSOR_FIELDS})


def _camera_to_device(cam: Camera, device) -> Camera:
    return dataclasses.replace(cam, **{f: torch.as_tensor(getattr(cam, f), device=device)
                                       for f in _TENSOR_FIELDS})


def save_mapper(mapper, path: str):
    """Write a full checkpoint directory for an IncrementalMapper."""
    os.makedirs(path, exist_ok=True)
    torch.save(_device_state(mapper), os.path.join(path, DEVICE_FILE))
    host = {
        "iter": mapper.iter,
        "started": mapper.started,
        "registry": mapper.registry._ranges,
        "loss_anchors": mapper.loss_anchors,
        "cameras": [_camera_to_host(c) for c in mapper.cameras],
        "gt_images": mapper.gt_images,
        "last_key_pose": mapper._last_key_pose,
        "gpmap_cells": {
            h: (c.ijk, c.points, c.variance, c.converged)
            for h, c in mapper.gpmap.cells.items()
        },
        "gpmap_pending": mapper.gpmap._pending,
        # deferred-colorization pool (pipeline.py): voxels whose GP ran but
        # which no camera has fully seen — dropping them on resume would
        # reintroduce the permanent-hole failure their pool exists to fix
        "pending_color": mapper._pending_color,
    }
    with open(os.path.join(path, HOST_FILE), "wb") as f:
        pickle.dump(host, f)


@torch.no_grad()
def _restore_device_state(mapper, state: dict):
    params, opt = mapper.params, mapper.optimizer
    saved = state["params"]
    cap = saved["xyz"].shape[0]
    if cap < params.capacity:
        raise ValueError(f"the checkpoint holds {cap} rows, fewer than this mapper's "
                         f"capacity {params.capacity}: build it with a smaller "
                         "initial_capacity")
    if cap > params.capacity:
        old = params.capacity
        gm.grow_capacity(params, cap)
        training.grow_opt_state(opt, old, cap)
    for name, value in saved.items():
        getattr(params, name).copy_(value)
    for group in opt.param_groups:
        s = state["adam"][group["name"]]
        if not s:  # no step taken yet
            continue
        p = group["params"][0]
        # Adam keeps `step` on the host unless it is capturable or fused
        opt.state[p] = {"step": s["step"].to("cpu"),
                        "exp_avg": s["exp_avg"].to(p.device).clone(),
                        "exp_avg_sq": s["exp_avg_sq"].to(p.device).clone()}


def load_mapper(mapper, path: str):
    """Restore state saved by save_mapper into a freshly-built mapper
    (configs must match; its capacity no larger than the saved one).
    Returns the mapper."""
    state = torch.load(os.path.join(path, DEVICE_FILE), weights_only=True,
                       map_location=mapper.device)
    _restore_device_state(mapper, state)

    with open(os.path.join(path, HOST_FILE), "rb") as f:
        host = pickle.load(f)
    mapper.iter = host["iter"]
    mapper.started = host["started"]
    # registry values are LISTS of (start, count) ranges since the r5
    # multi-range extension; normalize tuple-valued entries from older
    # sidecars so lookup()/ranges() see the same shape either way
    mapper.registry._ranges = {
        h: (list(v) if isinstance(v, list) else [tuple(v)])
        for h, v in host["registry"].items()
    }
    mapper._pending_color = host.get("pending_color", {})
    mapper._simi_cache = None  # anchors/registry just changed
    mapper.loss_anchors = host["loss_anchors"]
    mapper.cameras = [_camera_to_device(c, mapper.device) for c in host["cameras"]]
    mapper.gt_images = host["gt_images"]
    # re-stage the device-resident GT stack and its per-keyframe SSIM
    # reference statistics (pure functions of the GT images: rebuilt, not
    # serialized)
    mapper._gt_device = [torch.from_numpy(np.asarray(g)).to(mapper.device)
                         for g in mapper.gt_images]
    with torch.no_grad():
        mapper._gt_stats = [loss_ops.ssim_ref_stats(g) for g in mapper._gt_device]
    mapper._last_key_pose = host["last_key_pose"]
    mapper.gpmap.cells = {
        h: _Cell(ijk=ijk, points=pts, variance=var, converged=conv)
        for h, (ijk, pts, var, conv) in host["gpmap_cells"].items()
    }
    mapper.gpmap._pending = host["gpmap_pending"]
    return mapper
