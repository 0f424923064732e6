"""The Gaussian map model: parameters, capacity growth, pruning, the
voxel-hash registry and PLY I/O (port of gslivm_tpu/models/gaussian_model.py).

Behavioral spec: reference `src/gs/gaussian.cu` / `gaussian.cuh`:
  - parameter tensors and activations (gaussian.cuh:115-122, 40-54): xyz
    (raw), features_dc/rest (raw SH), scaling (log -> exp), rotation (quat
    -> normalize), opacity (logit -> sigmoid).
  - Create_from_pcd (gaussian.cu:325-386): scaling = log(sqrt(diag(cov) *
    scale_factor)), rotation = identity quat, opacity = inverse_sigmoid(0.5)
    = 0, DC feature = RGB2SH(rgb/255), rest = 0.
  - addNewPointcloud (gaussian.cu:241-313) with its optimizer surgery
    (cat_tensors_to_optimizer, gaussian.cu:451-472): parameters live in
    capacity-padded buffers with an `n_active` count, as in the JAX package;
    an append writes into padded rows and the capacity doubles when full.
  - voxel hash -> index registry (gaussian.cuh:124, gaussian.cu:257-263).
  - Save_ply (gaussian.cu:494-519) with the attribute layout of
    construct_list_of_attributes (gaussian.cu:474-492), so a PLY written by
    either package loads in the other.

Growth and compaction work IN PLACE: each `nn.Parameter` keeps its identity
and only its `.data` is replaced, so a `torch.optim.Adam` built over the
module keeps stepping the same objects (training.grow_opt_state and
compact_opt_state carry its moments along).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops import sh as sh_ops
from ..utils.device import resolve_device


def inverse_sigmoid(x):
    """general_utils.cuh:15."""
    return torch.log(x / (1.0 - x))


class GaussianParams(nn.Module):
    """Capacity-padded trainable parameters. Leading dim = capacity;
    the `n_active` buffer marks the live prefix."""

    def __init__(self, xyz, features_dc, features_rest, scaling, rotation,
                 opacity, n_active):
        super().__init__()
        self.xyz = nn.Parameter(xyz)                      # [C, 3]
        self.features_dc = nn.Parameter(features_dc)      # [C, 1, 3]
        self.features_rest = nn.Parameter(features_rest)  # [C, K-1, 3]
        self.scaling = nn.Parameter(scaling)              # [C, 3] log-scale
        self.rotation = nn.Parameter(rotation)            # [C, 4] (w,x,y,z)
        self.opacity = nn.Parameter(opacity)              # [C, 1] logit
        self.register_buffer("n_active", torch.as_tensor(
            n_active, dtype=torch.int32, device=xyz.device))

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(np.sqrt(self.features_rest.shape[1] + 1)) - 1

    def active_mask(self):
        return torch.arange(self.capacity, device=self.xyz.device) < self.n_active

    # --- activations (gaussian.cuh:40-54) ---
    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_rotation(self):
        return self.rotation / torch.linalg.norm(
            self.rotation, dim=-1, keepdim=True).clip(min=1e-12)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_features(self):
        """[C, K, 3] concatenated SH features."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)


def create_empty(capacity: int, sh_degree: int = 0, dtype=torch.float32,
                 device="cuda") -> GaussianParams:
    dev = resolve_device(device)
    k = sh_ops.num_sh_coeffs(sh_degree)
    rotation = torch.zeros((capacity, 4), dtype=dtype, device=dev)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=torch.zeros((capacity, 3), dtype=dtype, device=dev),
        features_dc=torch.zeros((capacity, 1, 3), dtype=dtype, device=dev),
        features_rest=torch.zeros((capacity, k - 1, 3), dtype=dtype, device=dev),
        scaling=torch.full((capacity, 3), -10.0, dtype=dtype, device=dev),
        rotation=rotation,
        opacity=torch.full((capacity, 1), -10.0, dtype=dtype, device=dev),
        n_active=0,
    )


class PointBatch(NamedTuple):
    """A batch of GPR-initialized gaussians to insert (fixed-size, masked)."""

    xyz: torch.Tensor   # [M, 3]
    rgb: torch.Tensor   # [M, 3] in [0, 255] (uint8-valued floats)
    cov: torch.Tensor   # [M, 3, 3]
    mask: torch.Tensor  # [M] bool, valid entries


def _init_fields(xyz, rgb, cov_diag, scale_factor: float, sh_degree: int):
    """Create_from_pcd field math (gaussian.cu:325-386)."""
    n = xyz.shape[0]
    k = sh_ops.num_sh_coeffs(sh_degree)
    scaling = torch.log(torch.sqrt(torch.clamp(cov_diag * scale_factor, min=1e-12)))
    rotation = torch.zeros((n, 4), dtype=xyz.dtype, device=xyz.device)
    rotation[:, 0] = 1.0
    opacity = torch.zeros((n, 1), dtype=xyz.dtype, device=xyz.device)  # inverse_sigmoid(0.5)
    dc = sh_ops.rgb_to_sh(rgb / 255.0)[:, None, :]
    rest = torch.zeros((n, k - 1, 3), dtype=xyz.dtype, device=xyz.device)
    return scaling, rotation, opacity, dc, rest


def _stable_partition(mask):
    """The permutation that moves mask's True entries to the front, each
    side in its original order. argsort of a non-bool key with stable=True:
    the registry remap and the Adam compaction rely on the kept order."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def create_from_points(batch: PointBatch, scale_factor: float, capacity: int,
                       sh_degree: int = 0) -> GaussianParams:
    """Create_from_pcd equivalent into a fresh capacity-padded model on the
    batch's device."""
    params = create_empty(capacity, sh_degree, batch.xyz.dtype, device=batch.xyz.device)
    return append_points(params, batch, scale_factor)


def _compact_batch(batch: PointBatch):
    """Stable-partition valid entries to the front; returns count (a 0-d
    tensor)."""
    order = _stable_partition(batch.mask)
    count = batch.mask.sum().to(torch.int32)
    return PointBatch(
        xyz=batch.xyz[order], rgb=batch.rgb[order], cov=batch.cov[order],
        mask=torch.arange(batch.mask.shape[0], device=batch.mask.device) < count,
    ), count


@torch.no_grad()
def append_points(params: GaussianParams, batch: PointBatch,
                  scale_factor: float) -> GaussianParams:
    """addNewPointcloud equivalent: write the batch's valid rows into the
    padded rows [n_active, n_active + count), in place; returns `params`.

    Rows that do not fit in the capacity are dropped (callers grow the
    capacity first with `ensure_capacity`), as the JAX package's
    mode="drop" scatter drops them: torch has no such mode, so they are
    masked out before the indexed write (a boolean mask, so the call waits
    for the device once).
    """
    cbatch, count = _compact_batch(batch)
    m = cbatch.xyz.shape[0]
    cap = params.capacity
    start = params.n_active.to(torch.int64)

    cov_diag = torch.diagonal(cbatch.cov, dim1=-2, dim2=-1)
    fields = _init_fields(cbatch.xyz, cbatch.rgb, cov_diag, scale_factor,
                          params.sh_degree)

    dst = start + torch.arange(m, device=params.xyz.device)
    ok = (torch.arange(m, device=params.xyz.device) < count) & (dst < cap)
    dst = dst[ok]
    for param, rows in zip((params.xyz, params.scaling, params.rotation,
                            params.opacity, params.features_dc,
                            params.features_rest),
                           (cbatch.xyz, *fields)):
        param[dst] = rows[ok].to(param.dtype)
    params.n_active.copy_(torch.clamp(start + count, max=cap))
    return params


def prune_permutation(params: GaussianParams, keep_mask):
    """(order, count) of the stable partition that compacts `keep_mask`.

    `order` moves kept gaussians to the front preserving their relative
    order; apply it to the parameters (compact) AND to the Adam moments
    (training.compact_opt_state) so optimizer state follows its gaussian.
    """
    keep_mask = torch.as_tensor(keep_mask, device=params.xyz.device) & params.active_mask()
    return _stable_partition(keep_mask), keep_mask.sum().to(torch.int32)


def _take_rows(buf, order, count):
    """buf[order] with every row at or past `count` ZEROED (not reset to
    create_empty's -10: the JAX package's compact zeroes them too)."""
    live = torch.arange(buf.shape[0], device=buf.device) < count
    return torch.where(live.reshape((-1,) + (1,) * (buf.dim() - 1)), buf[order], 0.0)


@torch.no_grad()
def compact(params: GaussianParams, order, count) -> GaussianParams:
    """Apply a prune permutation in place: kept rows to the front, the rest
    zeroed. Returns `params`."""
    for param in params.parameters():
        param.data = _take_rows(param.data, order, count)
        param.grad = None
    params.n_active.copy_(count)
    return params


def prune(params: GaussianParams, keep_mask) -> GaussianParams:
    """Compact the model in place to the gaussians where keep_mask is True.

    The reference DEFINES prune_optimizer but never calls it (gaussian.cu:
    430); the Adam state is compacted with the same permutation by
    prune_permutation + training.compact_opt_state. Stable order is kept.
    """
    order, count = prune_permutation(params, keep_mask)
    return compact(params, order, count)


def prune_low_opacity(params: GaussianParams, min_opacity: float = 0.005) -> GaussianParams:
    """Drop gaussians whose activated opacity fell below min_opacity."""
    with torch.no_grad():
        keep = params.get_opacity()[:, 0] >= min_opacity
    return prune(params, keep)


# The rank id of a gaussian rides through the tile tables as an exact f32
# (the JAX kernels' _FID, rasterize_pallas.py:81; the port's
# csrc/tile_common.cuh), so both packages render exactly only up to 2^24
# gaussians.
MAX_CAPACITY = 2**24


@torch.no_grad()
def grow_capacity(params: GaussianParams, new_capacity: int) -> GaussianParams:
    """Pad every buffer to `new_capacity` rows with create_empty's values,
    in place (each Parameter keeps its identity; its stale .grad is
    dropped); active data unchanged. Returns `params`."""
    assert new_capacity >= params.capacity
    pad = new_capacity - params.capacity
    if pad == 0:
        return params
    empty = create_empty(pad, params.sh_degree, params.xyz.dtype, device=params.xyz.device)
    for name, param in params.named_parameters():
        param.data = torch.cat([param.data, getattr(empty, name).data], dim=0)
        param.grad = None
    return params


def ensure_capacity(params: GaussianParams, incoming: int,
                    growth: float = 2.0) -> GaussianParams:
    """Grow (by doubling) until `incoming` more gaussians fit. Reads
    n_active from the device.

    Raises ValueError when the capacity needed passes 2^24 (MAX_CAPACITY):
    a larger map's rank ids would not be exact in f32, and it would render
    wrongly without a word.
    """
    needed = int(params.n_active) + incoming
    if needed > MAX_CAPACITY:
        raise ValueError(
            f"the map needs {needed} gaussians, more than 2^24 = {MAX_CAPACITY}: "
            "the tile kernels carry gaussian ids as exact float32")
    cap = params.capacity
    while cap < needed:
        cap = max(int(cap * growth), cap + 1)
    return grow_capacity(params, min(cap, MAX_CAPACITY))


class HashIndexRegistry:
    """Host-side voxel-hash -> gaussian index-range registry
    (gs_hash_indexes_, gaussian.cuh:124). Duplicate insertion is an error in
    the reference (gaussian.cu:257-262); here it is reported by return value.

    A voxel may hold SEVERAL index ranges: the deferred-colorization pool
    (pipeline.IncrementalMapper) inserts the visible subset of a voxel's
    gaussians at once and appends the remainder when a later camera sees
    it, as the JAX package does."""

    def __init__(self):
        self._ranges: dict[int, list[tuple[int, int]]] = {}

    def insert(self, voxel_hash: int, start: int, count: int) -> bool:
        """First-range insert; False (reference error analog) if present."""
        if voxel_hash in self._ranges:
            return False
        self._ranges[voxel_hash] = [(start, count)]
        return True

    def append_range(self, voxel_hash: int, start: int, count: int):
        """Deferred-completion insert: add another range to a voxel."""
        self._ranges.setdefault(voxel_hash, []).append((start, count))

    def lookup(self, voxel_hash: int):
        """The FIRST range of the voxel (reference API shape), or None."""
        r = self._ranges.get(voxel_hash)
        return r[0] if r else None

    def ranges(self, voxel_hash: int) -> list:
        """All index ranges of the voxel ([] when absent)."""
        return self._ranges.get(voxel_hash, [])

    def remap_pruned(self, keep: np.ndarray):
        """Remap index ranges after prune(keep): the stable partition keeps
        relative order, so every surviving range stays CONTIGUOUS; its new
        start is the number of kept gaussians before its old start. Ranges
        whose gaussians were all dropped are removed."""
        keep = np.asarray(keep, bool)
        prefix = np.concatenate([[0], np.cumsum(keep.astype(np.int64))])
        new: dict[int, list[tuple[int, int]]] = {}
        for h, rs in self._ranges.items():
            kept = []
            for s, c in rs:
                nc = int(prefix[s + c] - prefix[s])
                if nc > 0:
                    kept.append((int(prefix[s]), nc))
            if kept:
                new[h] = kept
        self._ranges = new

    def indices_for(self, hashes) -> np.ndarray:
        out = []
        for h in hashes:
            for s, c in self._ranges.get(int(h), []):
                out.extend(range(s, s + c))
        return np.asarray(out, dtype=np.int32)

    def __len__(self):
        return len(self._ranges)


def save_ply(params: GaussianParams, path: str):
    """Write the 3DGS-standard binary-little-endian PLY of the live prefix."""
    n = int(params.n_active)

    def host(p, width):
        return p.detach()[:n].to("cpu", torch.float32).numpy().reshape(n, width)

    xyz = host(params.xyz, 3)
    normals = np.zeros_like(xyz)
    # SH features channel-major per gaussian, like the reference's transpose(1, 2)
    f_dc = host(params.features_dc.transpose(1, 2), params.features_dc.shape[1] * 3)
    f_rest = host(params.features_rest.transpose(1, 2), params.features_rest.shape[1] * 3)
    opacity = host(params.opacity, 1)
    scale = host(params.scaling, 3)
    rot = host(params.rotation, 4)

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(scale.shape[1])]
        + [f"rot_{i}" for i in range(rot.shape[1])]
    )
    data = np.concatenate([xyz, normals, f_dc, f_rest, opacity, scale, rot], axis=1)

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {p}" for p in props]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.astype("<f4").tobytes())


def load_ply(path: str, sh_degree: int = 0, capacity: int | None = None,
             device="cuda") -> GaussianParams:
    """Read a PLY written by save_ply (of either package) onto `device`."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4")
    data = data.reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}
    k = sh_ops.num_sh_coeffs(sh_degree)
    n_rest = 3 * (k - 1)

    def cols(names):
        return torch.from_numpy(np.ascontiguousarray(
            data[:, [col[c] for c in names]])).to(dev)

    params = create_empty(capacity or max(n, 1), sh_degree, device=dev)
    with torch.no_grad():
        params.xyz[:n] = cols(["x", "y", "z"])
        params.features_dc[:n] = cols(
            [f"f_dc_{i}" for i in range(3)]).reshape(n, 3, 1).transpose(1, 2)
        if n_rest:
            params.features_rest[:n] = cols(
                [f"f_rest_{i}" for i in range(n_rest)]).reshape(n, 3, k - 1).transpose(1, 2)
        params.scaling[:n] = cols([f"scale_{i}" for i in range(3)])
        params.rotation[:n] = cols([f"rot_{i}" for i in range(4)])
        params.opacity[:n] = cols(["opacity"])
        params.n_active.fill_(n)
    return params
