"""Max-match kernel of the exhaustive hammings engine.

`minmm` launches the hand-written CUDA kernel `csrc/minmm.cu` on CUDA
tensors; it replaces the TPU kernel `_minmm_kernel` of
kit4b_tpu/kmer/hammings_mxu.py. On CPU tensors it runs `minmm_plain`, the
plain PyTorch version of the same function, which the tests hold against the
JAX package and which the on-card smoke test holds the kernel against.

Both compute, for every own row i of `W_own` (global row `row_base + i`),

    max over partner columns j in [span_lo*S, (span_lo+span_cnt)*S)
        of the int8 dot product W_own[i] . W_part[j]

with the self pair (row_base + i == j) counted as NEG when `diag` is set.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG = -(1 << 20)
TILE = 128      # granule of own rows and partner columns (csrc/minmm.cu kTile)
MAX_CW = 768    # widest row the kernel is instantiated for (K <= 153)


def minmm_plain(W_own: torch.Tensor, W_part: torch.Tensor, *, diag: bool,
                span_lo: int, span_cnt: int, S: int,
                row_base: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel ([R] int32); its spec is
    `_minmm_xla` of kit4b_tpu/kmer/hammings_mxu.py.

    Multiplies one span of S partner columns at a time, so no [R, span]
    matrix is ever whole. On the CPU it multiplies in int32. On CUDA, which
    has no integer matmul in torch, it multiplies in float16: exact while
    every dot product is an integer of magnitude at most 2048, as one-hot
    window rows (at most K matches) give."""
    R = W_own.shape[0]
    dt = torch.int32 if W_own.device.type == "cpu" else torch.float16
    fill = NEG if dt == torch.int32 else float("-inf")
    wo = W_own.to(dt)
    best = torch.full((R,), NEG, dtype=torch.int32, device=W_own.device)
    for s in range(span_lo, span_lo + span_cnt):
        c0 = s * S
        m = wo @ W_part[c0:c0 + S].to(dt).T
        i_lo, i_hi = max(c0 - row_base, 0), min(c0 + S - row_base, R)
        if diag and i_lo < i_hi:   # own row i is partner column row_base + i
            i = torch.arange(i_lo, i_hi, device=m.device)
            m[i, i + (row_base - c0)] = fill
        mx = m.amax(1)
        if mx.is_floating_point():
            mx = mx.float().clamp(min=NEG)   # a fully masked row reads NEG
        best = torch.maximum(best, mx.to(torch.int32))
    return best


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("minmm")
    lib.minmm_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.minmm_launch.restype = ctypes.c_int
    return lib


def minmm(W_own: torch.Tensor, W_part: torch.Tensor, *, diag: bool,
          span_lo: int, span_cnt: int, S: int,
          row_base: int = 0) -> torch.Tensor:
    """[R] int32 max matches: the CUDA kernel for CUDA tensors, `minmm_plain`
    for CPU tensors. Each kernel launch adds one to `minmm.launches`."""
    if W_own.device.type == "cpu" and W_part.device.type == "cpu":
        return minmm_plain(W_own, W_part, diag=diag, span_lo=span_lo,
                           span_cnt=span_cnt, S=S, row_base=row_base)
    R, cw = W_own.shape
    col_lo, col_hi = span_lo * S, (span_lo + span_cnt) * S
    if W_own.device != W_part.device or W_own.device.type != "cuda":
        raise ValueError(f"minmm: W_own on {W_own.device}, W_part on "
                         f"{W_part.device}; both must be on one CUDA device")
    if W_own.dtype != torch.int8 or W_part.dtype != torch.int8:
        raise ValueError("minmm: W_own and W_part must be int8")
    if not (W_own.is_contiguous() and W_part.is_contiguous()):
        raise ValueError("minmm: W_own and W_part must be contiguous")
    if W_part.dim() != 2 or W_part.shape[1] != cw:
        raise ValueError(f"minmm: W_part {tuple(W_part.shape)} does not match "
                         f"W_own width {cw}")
    if cw % TILE or cw > MAX_CW:
        raise ValueError(f"minmm: width {cw} must be a multiple of {TILE} "
                         f"and at most {MAX_CW} (K <= 153)")
    if R % TILE or (col_hi - col_lo) % TILE:
        raise ValueError(f"minmm: rows {R} and span width {col_hi - col_lo} "
                         f"must be multiples of {TILE}")
    if span_lo < 0 or col_hi > W_part.shape[0]:
        raise ValueError(f"minmm: partner columns [{col_lo}, {col_hi}) "
                         f"outside W_part's {W_part.shape[0]} rows")
    out = torch.empty(R, dtype=torch.int32, device=W_own.device)
    if R == 0:
        return out
    dev = W_own.device.index if W_own.device.index is not None \
        else torch.cuda.current_device()
    err = _lib().minmm_launch(
        dev, W_own.data_ptr(), W_part.data_ptr(), R, W_part.shape[0], cw,
        col_lo, col_hi, int(diag), row_base, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"minmm kernel launch failed: CUDA error {err}")
    minmm.launches += 1
    return out


minmm.launches = 0
