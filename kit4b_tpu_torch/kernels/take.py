"""Table gather of the gather profiler.

`take` launches the hand-written CUDA kernel `csrc/take.cu` on CUDA
tensors; it replaces the TPU kernel `kernel_take` of
tools/archive/profile_pallas_gather.py (launched by `pallas_take`). On CPU
tensors it runs `take_plain`, the plain PyTorch version of the same
function. Both give `jnp.take(table, idx, axis=0)` for int32 tables as JAX
does: an index in [-T, -1] counts from the end, and an index below -T or
at or past T reads INT32_MIN (torch's own `table[idx]` raises on both).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

FILL = -(1 << 31)    # jnp.take's fill value for an int32 index out of range


def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel ([N] int32)."""
    T = table.shape[0]
    if T == 0:
        return torch.full_like(idx, FILL)
    i = idx.long()
    i = torch.where(i < 0, i + T, i)
    return torch.where((i >= 0) & (i < T), table[i.clamp(0, T - 1)], FILL)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("take")
    lib.take_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.take_launch.restype = ctypes.c_int
    return lib


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N] int32 gather: the CUDA kernel for CUDA tensors, `take_plain` for
    CPU tensors. Each kernel launch adds one to `take.launches`."""
    for name, t in (("table", table), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"take: {name} must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return take_plain(table, idx)
    if table.device != idx.device or table.device.type != "cuda":
        raise ValueError(f"take: table on {table.device}, idx on "
                         f"{idx.device}; both must be on one CUDA device")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("take: table and idx must be contiguous")
    out = torch.empty_like(idx)
    if idx.shape[0] == 0:
        return out
    dev = table.device.index if table.device.index is not None \
        else torch.cuda.current_device()
    err = _lib().take_launch(
        dev, table.data_ptr(), table.shape[0], idx.data_ptr(),
        out.data_ptr(), idx.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"take kernel launch failed: CUDA error {err}")
    take.launches += 1
    return out


take.launches = 0
