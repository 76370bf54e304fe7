"""Offset-sweep kernel of the legacy exhaustive hammings engine.

`sweep` launches the hand-written CUDA kernel `csrc/sweep.cu` on CUDA
tensors; it replaces the TPU kernel `_sweep_kernel` of
kit4b_tpu/kmer/hammings_kernel.py (launched by `_run_sweep`). On CPU tensors
it runs `sweep_plain`, the plain PyTorch version of the same function, which
the tests hold against the JAX package and which the on-card smoke test
holds the kernel against.

Both compute, for every own window start i of `own` ([G] uint8 codes),

    out[i] = min over offsets d in [d_lo, d_hi) of
             sum_{k<K} [own[i+k] != partner[i+d+k]]

over the pairs whose own window and partner window both end at or before
G_valid and hold no sentinel (a code >= 5; N = 4 is an ordinary code, so N
matches N), and BIG where no pair counts. Codes past an array's end read as
EOG, a sentinel. The default d_hi takes every offset, as `_run_sweep` does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..dna import BASE_EOG
from . import build

BIG = 9999        # no valid pair (the JAX package's BIG)
PENALTY = 32      # a sentinel's weight; a pair counts while its sum is below it
MAX_K = 25        # K < PENALTY keeps every sentinel-free sum below PENALTY
MAX_G = 65535 * 1024   # own positions: the grid's y axis holds 65,535 tiles of 1,024
BATCH = 256       # offsets per [D, L] block of the plain version


def sweep_plain(own: torch.Tensor, partner: torch.Tensor, *, K: int,
                G_valid: int, d_lo: int, d_hi: int | None = None
                ) -> torch.Tensor:
    """Plain PyTorch version of the kernel ([G] int32); its spec is
    `_sweep_kernel` + `_run_sweep` of kit4b_tpu/kmer/hammings_kernel.py.

    Takes BATCH offsets at a time as [D, L] blocks. Each position of a
    pair adds its mismatch plus PENALTY if either code is a sentinel, and a
    pair counts while its window sum is below PENALTY. Partner codes at or
    past G_valid read as EOG, so that cut also drops every partner window
    that ends past G_valid."""
    G = own.shape[0]
    dev = own.device
    out = torch.full((G,), BIG, dtype=torch.int32, device=dev)
    n_win = G_valid - K + 1            # own window starts with i + K <= G_valid
    d_end = n_win if d_hi is None else min(d_hi, n_win)
    if d_lo >= d_end:
        return out
    o = own[:G_valid]
    p_real = partner[:G_valid]
    p = torch.cat([p_real, torch.full((G_valid - p_real.shape[0] + BATCH,),
                                      BASE_EOG, dtype=torch.uint8,
                                      device=dev)])
    o_pen = (o >= 5).to(torch.int16) * PENALTY
    p_pen = (p >= 5).to(torch.int16) * PENALTY
    for d0 in range(d_lo, d_end, BATCH):
        D = min(BATCH, d_end - d0)
        L = n_win - d0                 # own starts whose window at d0 fits
        J = L + K - 1                  # codes those windows read
        pw = p.unfold(0, J, 1)[d0:d0 + D]        # pw[r, j] = p[d0 + r + j]
        dvp = (o[:J] != pw).to(torch.int16) + torch.maximum(
            o_pen[:J], p_pen.unfold(0, J, 1)[d0:d0 + D])
        ws = dvp[:, :L].clone()
        for k in range(1, K):
            ws += dvp[:, k:k + L]
        best = torch.where(ws < PENALTY, ws, BIG).amin(0)
        out[:L] = torch.minimum(out[:L], best.to(torch.int32))
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sweep")
    lib.sweep_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    lib.sweep_launch.restype = ctypes.c_int
    return lib


def sweep(own: torch.Tensor, partner: torch.Tensor, *, K: int, G_valid: int,
          d_lo: int, d_hi: int | None = None) -> torch.Tensor:
    """[G] int32 running minima: the CUDA kernel for CUDA tensors,
    `sweep_plain` for CPU tensors. Each kernel launch adds one to
    `sweep.launches`."""
    for name, t in (("own", own), ("partner", partner)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(f"sweep: {name} must be 1-D uint8 codes, got "
                             f"{t.dtype} {tuple(t.shape)}")
    G = own.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"sweep: K must be in [1, {MAX_K}], got {K}")
    if not 0 <= G_valid <= G or d_lo < 0:
        raise ValueError(f"sweep: want 0 <= G_valid <= {G} and d_lo >= 0, "
                         f"got G_valid={G_valid} d_lo={d_lo}")
    if own.device.type == "cpu" and partner.device.type == "cpu":
        return sweep_plain(own, partner, K=K, G_valid=G_valid, d_lo=d_lo,
                           d_hi=d_hi)
    if own.device != partner.device or own.device.type != "cuda":
        raise ValueError(f"sweep: own on {own.device}, partner on "
                         f"{partner.device}; both must be on one CUDA device")
    if not (own.is_contiguous() and partner.is_contiguous()):
        raise ValueError("sweep: own and partner must be contiguous")
    if G > MAX_G:
        raise ValueError(f"sweep: {G} own positions; the kernel takes at "
                         f"most {MAX_G}")
    out = torch.full((G,), BIG, dtype=torch.int32, device=own.device)
    n_win = G_valid - K + 1
    d_end = n_win if d_hi is None else min(d_hi, n_win)
    if d_lo >= d_end:
        return out
    dev = own.device.index if own.device.index is not None \
        else torch.cuda.current_device()
    err = _lib().sweep_launch(
        dev, own.data_ptr(), G_valid, partner.data_ptr(),
        min(partner.shape[0], G_valid), K, d_lo, d_end, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
    sweep.launches += 1
    return out


sweep.launches = 0
