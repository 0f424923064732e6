"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes. A library
is named after a hash of its source, the `csrc/` headers it includes, the
nvcc flags and the nvcc version, under `gslivm_tpu_torch/build/`, so an
edited source, header, flag or compiler rebuilds it and an unchanged one is
reused. Nothing is built
at import time: the first wrapper that launches a kernel on a CUDA tensor
builds it, or a caller builds every kernel at once with `build()`, which
runs one nvcc per source in parallel.

Flags: -O3, no --use_fast_math (fast division and flushed denormals
everywhere would move the 1/255 alpha and 1e-4 transmittance decisions of
the tile kernels; their one fast operation, the exp, is named in
`csrc/tile_common.cuh`); nvcc's default FMA contraction is kept.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("tile_forward", "tile_backward", "blur", "microbench_fetch",
           "microbench_fwdablate")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point and argument types of each library; every pointer and the
# stream go as c_void_p (a plain int would be cut to 32 bits)
_SIGNATURES = {
    # inst, sorted_start, tile_nchunks, cnt_allowed, out, ckpt (or null),
    # num_tiles, grid_x, pw, ph, max_chunks, rect_test, contrib_stats, stream
    "tile_forward": ("tile_forward", [_P] * 6 + [_I] * 7 + [_P]),
    # inst, sorted_start, cnt_allowed, g_tiles, fwd_tiles, ckpt, out,
    # num_gaussians, num_tiles, grid_x, pw, ph, max_chunks, rect_test,
    # depth_grad, stream
    "tile_backward": ("tile_backward", [_P] * 7 + [_I] * 8 + [_P]),
    # x, y, n, h, w, taps (host float*), k, vec, strip, stream
    "blur": ("blur_many", [_P, _P, _I, _I, _I, _P, _I, _I, _I, _P]),
    # inst, off, nch, out, num_tiles, rows, variant, stream
    "microbench_fetch": ("microbench_fetch", [_P] * 4 + [_I] * 3 + [_P]),
    # inst, start, nchunks, count, out, num_tiles, grid_x, variant,
    # accept_thr, stream
    "microbench_fwdablate": ("microbench_fwdablate",
                             [_P] * 5 + [_I] * 3 + [ctypes.c_float, _P]),
}

# these libraries also export `<name>_usage(<ints>, int out[5])`, the
# resource use of one instantiation; the number of ints it takes
_USAGE_ARGS = {"tile_forward": 1, "tile_backward": 2, "blur": 2, "microbench_fwdablate": 1}
USAGE_FIELDS = ("registers", "local_bytes", "static_smem", "dynamic_smem",
                "blocks_per_sm")

_FNS: dict = {}  # kernel name -> its loaded C entry point
_DLLS: dict = {}  # kernel name -> its loaded library
_LOAD_LOCK = threading.Lock()  # one thread builds and loads a library


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """`nvcc --version`, or "" where there is no nvcc (nothing is built then)."""
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is None:
        return ""
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout


def _local_headers(source: bytes) -> list[str]:
    """The `csrc/` headers a source includes with #include "...", in order."""
    return re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.decode(), re.M)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _local_headers(src):
        h.update(header.encode())
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns {name: compiler output} for the
    libraries built by this call; raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(name)
    if failed:
        detail = "\n".join(f"--- {n} ---\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def library(name: str):
    """The loaded C entry point of kernel `name`, built first if needed.
    Safe to call from several threads: one of them builds and loads."""
    if name not in _FNS:
        with _LOAD_LOCK:
            if name not in _FNS:
                build([name])
                fn_name, argtypes = _SIGNATURES[name]
                _DLLS[name] = ctypes.CDLL(str(library_path(name)))
                fn = getattr(_DLLS[name], fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[name] = fn
    return _FNS[name]


def usage(name: str, *instantiation: int) -> dict[str, int]:
    """Resource use of one instantiation of kernel `name` (tile_forward:
    pixels a thread; tile_backward: pixels a thread and depth_grad; blur:
    taps and float4; microbench_fwdablate: the variant's index) as the CUDA
    runtime reports it for the current device: registers and local (stack
    and spill) bytes per thread, static and dynamic shared bytes per block,
    and the blocks one SM holds at once."""
    library(name)
    fn = getattr(_DLLS[name], f"{name}_usage")
    fn.argtypes = [_I] * _USAGE_ARGS[name] + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(USAGE_FIELDS))()
    err = fn(*instantiation, out)
    if err:
        raise RuntimeError(f"{name}_usage{instantiation} failed: CUDA error {err}")
    return dict(zip(USAGE_FIELDS, out))
