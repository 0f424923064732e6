"""The Gaussian map container (port of the container half of
gslivm_tpu/models/gaussian_model.py: parameters, activations, PLY I/O).

Behavioral spec: reference `src/gs/gaussian.cu` / `gaussian.cuh`:
parameter tensors and activations (gaussian.cuh:115-122, 40-54): xyz (raw),
features_dc/rest (raw SH), scaling (log -> exp), rotation (quat ->
normalize), opacity (logit -> sigmoid); Save_ply (gaussian.cu:494-519) with
the attribute layout of construct_list_of_attributes (gaussian.cu:474-492).

Parameters live in capacity-padded buffers with an `n_active` count, as in
the JAX package, so a PLY written by either package loads in the other.
Growth, pruning and the voxel-hash registry come with later slices.
"""

from __future__ import annotations

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
