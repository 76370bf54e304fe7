"""Explicit device resolution for the port.

CUDA is the default. A request for CUDA on a machine without it raises
`DeviceUnavailable`: the port never drops to the CPU on its own. The CPU
runs each kernel's plain PyTorch version and is taken only when asked for.
"""
from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device is not present."""


def resolve(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the port runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {dev} requested but CUDA is not available "
            "(torch.cuda.is_available() is false); ask for the CPU "
            "explicitly (--device cpu) to run the plain PyTorch path")
    return dev
