"""gslivm_tpu_torch — the PyTorch + CUDA port of gslivm_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (`models/`, `ops/`, `utils/`)
and function names, so each module has an obvious counterpart in
`gslivm_tpu`. It imports torch and numpy only.

Kernels written by hand in CUDA C++ live in `csrc/` and are compiled with
nvcc at first use (`kernels.py`). Nothing here builds or imports a kernel
at import time, so the package imports on a machine without nvcc or a
card; on such a machine every wrapper runs its plain PyTorch version for
CPU tensors.

Entry points that create tensors (`make_camera`, `create_empty`,
`load_ply`, `convert.params_from_numpy`, `convert.camera_from_numpy`)
default to `device="cuda"` and raise when CUDA is absent, unless the
caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
