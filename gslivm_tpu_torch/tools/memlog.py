"""Per-frame device-memory logging (counterpart of gslivm_tpu/tools/memlog.py:
the reference samples nvidia-smi per odometry message; here PyTorch's CUDA
allocator is read).

Produces the `stamp,mb` CSV that a time plot's memory log reads.
"""

from __future__ import annotations

import time

import torch

from ..utils.device import resolve_device


def device_memory_mb(device="cuda") -> float:
    """Bytes held by PyTorch's allocator on a CUDA device, in MB; 0.0 for a
    device without allocator stats (the CPU, when asked for)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(dev) / 1e6


class MemoryLogger:
    """Append-mode `stamp,mb` sampler; call sample() once per frame."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        open(path, "w").close()

    def sample(self, stamp: float | None = None) -> float:
        mb = device_memory_mb(self.device)
        with open(self.path, "a") as f:
            f.write(f"{time.time() if stamp is None else stamp:.6f},"
                    f"{mb:.3f}\n")
        return mb
