"""Carries the JAX package's hammings state into the port.

`from_jax` takes a genome's codes and the window matrix W and validity mask
that kit4b_tpu's `hammings_mxu._build_w` produced for it, as numpy arrays,
and returns them as the port's tensors on an explicit device. The port's
kernel path can then run on exactly the JAX package's matrices.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve


def from_jax(codes, W, valid, device: str | torch.device = "cuda"
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes [G] uint8, W [Gp, Cw] int8, valid [Gp] bool) on `device`."""
    dev = resolve(device)
    codes, W, valid = np.asarray(codes), np.asarray(W), np.asarray(valid)
    if codes.dtype != np.uint8 or codes.ndim != 1:
        raise ValueError(f"codes: want 1-D uint8, got {codes.dtype} "
                         f"{codes.shape}")
    if W.dtype != np.int8 or W.ndim != 2 or W.shape[1] % 128:
        raise ValueError(f"W: want [Gp, Cw] int8 with Cw a multiple of 128, "
                         f"got {W.dtype} {W.shape}")
    if valid.dtype != np.bool_ or valid.shape != W.shape[:1]:
        raise ValueError(f"valid: want [{W.shape[0]}] bool, got "
                         f"{valid.dtype} {valid.shape}")
    # np.array copies: arrays that come from jax are read-only
    return tuple(torch.from_numpy(np.array(a)).to(dev)
                 for a in (codes, W, valid))
