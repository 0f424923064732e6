"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raise if it names CUDA and there is none.

    The port never drops to the CPU on its own: a caller that wants the CPU
    says so with device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name (torch.cuda.get_device_name) or the device's type, as
    the tools print it beside their numbers."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
