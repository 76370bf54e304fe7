"""Max-match kernel of the exhaustive hammings engine.

`minmm` launches the hand-written CUDA kernel `csrc/minmm.cu` on CUDA
tensors; it replaces the TPU kernel `_minmm_kernel` of
kit4b_tpu/kmer/hammings_mxu.py. On CPU tensors it runs `minmm_plain`, the
plain PyTorch version of the same function, which the tests hold against the
JAX package and which the on-card smoke test holds the kernel against.

Both compute, for every own row i of `W_own` (global row `row_base + i`),

    max over partner columns j in [span_lo*S, (span_lo+span_cnt)*S)
        of the int8 dot product W_own[i] . W_part[j - col_base]

with the self pair (row_base + i == j) counted as NEG when `diag` is set.
Row p of `W_part` is global column `col_base + p`, so the partner map may
hold one node's span alone; both bases are 64-bit and may pass 2^31.

The kernel runs on the card's 2:4-sparse int8 tensor path: it takes own
rows that hold at most two non-zeros in every aligned group of 4 channels,
as one-hot K-mer windows do. It counts the groups that hold more into a
device int of the launch's card (`faults`), which the caller reads at a
sync it already makes and hands to `raise_on_faults` (`check_faults` reads
and checks it in one step): the result of such a launch is wrong, and the
path raises in place of returning it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG = -(1 << 20)
TILE = 128      # granule of own rows and partner columns
MAX_CW = 768    # widest row the kernel is instantiated for (K <= 153)
PLAIN_ROWS = 1 << 21   # own rows a call of the plain version on the CPU


def minmm_plain(W_own: torch.Tensor, W_part: torch.Tensor, *, diag: bool,
                span_lo: int, span_cnt: int, S: int,
                row_base: int = 0, col_base: int = 0) -> torch.Tensor:
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
        m = wo @ W_part[c0 - col_base:c0 - col_base + S].to(dt).T
        i_lo, i_hi = max(c0 - row_base, 0), min(c0 + S - row_base, R)
        if diag and i_lo < i_hi:   # own row i is partner column row_base + i
            i = torch.arange(i_lo, i_hi, device=m.device)
            m[i, i + (row_base - c0)] = fill
        mx = m.amax(1)
        if mx.is_floating_point():
            mx = mx.float().clamp(min=NEG)   # a fully masked row reads NEG
        best = torch.maximum(best, mx.to(torch.int32))
    return best


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` with the C signature of csrc/minmm.cu's `minmm_launch`."""
    lib.minmm_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.minmm_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("minmm"))


_FAULTS: dict[torch.device, torch.Tensor] = {}


def faults(device: torch.device) -> torch.Tensor:
    """The int32 [1] count, on `device`, of own-row groups of 4 channels
    with more than two non-zeros that the kernel's launches there have met
    since the count was last found non-zero."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _FAULTS:
        _FAULTS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _FAULTS[device]


def raise_on_faults(count: int, device: torch.device) -> None:
    """Raises ValueError where `count`, a value of `faults(device)` read at
    a sync, is not 0, and sets the count back to 0 first."""
    if count:
        faults(device).zero_()
        raise ValueError(
            f"minmm: own rows hold {count} group(s) of 4 channels with more "
            "than 2 non-zeros; the kernel takes 2:4-sparse own rows (one-hot "
            "K-mer windows), and its result is dropped")


def check_faults(device: torch.device) -> None:
    """Reads `faults(device)`, which waits for the device, and raises where
    a launch met own rows that are not 2:4-sparse."""
    raise_on_faults(int(faults(device)[0]), device)


def _on_one_card(W_own: torch.Tensor, W_part: torch.Tensor) -> None:
    if W_own.device != W_part.device or W_own.device.type != "cuda":
        raise ValueError(f"minmm: W_own on {W_own.device}, W_part on "
                         f"{W_part.device}; both must be on one CUDA device")


def minmm(W_own: torch.Tensor, W_part: torch.Tensor, *, diag: bool,
          span_lo: int, span_cnt: int, S: int,
          row_base: int = 0, col_base: int = 0) -> torch.Tensor:
    """[R] int32 max matches: the CUDA kernel for CUDA tensors, `minmm_plain`
    for CPU tensors, on at most PLAIN_ROWS own rows a call, so the memory
    the CPU takes does not grow with R. Each kernel launch adds one to
    `minmm.launches` and its own rows to `minmm.rows` and to
    `minmm.rows_by_cw[cw]`, under the stored row width cw (128 * CH: the
    kernel's compile-time instantiation, Cw 128 for K <= 25, 512 for K 77
    to 102). The kernel takes
    fewer than 2^31 own rows and partner rows a launch, at any bases, and
    own rows that are 2:4-sparse (see the module's note: the caller checks
    `faults` at its next sync)."""
    if W_own.device.type == "cpu" and W_part.device.type == "cpu":
        return torch.cat([
            minmm_plain(W_own[r:r + PLAIN_ROWS], W_part, diag=diag,
                        span_lo=span_lo, span_cnt=span_cnt, S=S,
                        row_base=row_base + r, col_base=col_base)
            for r in range(0, max(W_own.shape[0], 1), PLAIN_ROWS)])
    R, cw = W_own.shape
    # the span's rows of W_part
    col_lo, col_hi = span_lo * S - col_base, (span_lo + span_cnt) * S - col_base
    _on_one_card(W_own, W_part)
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
    if col_lo < 0 or col_hi > W_part.shape[0]:
        raise ValueError(f"minmm: partner columns [{col_lo + col_base}, "
                         f"{col_hi + col_base}) outside W_part's "
                         f"{W_part.shape[0]} rows from column {col_base}")
    if R >= 1 << 31 or W_part.shape[0] >= 1 << 31:
        raise ValueError(f"minmm: {R} own rows and {W_part.shape[0]} "
                         f"partner rows must each be below 2^31")
    out = torch.empty(R, dtype=torch.int32, device=W_own.device)
    if R == 0:
        return out
    dev = W_own.device.index if W_own.device.index is not None \
        else torch.cuda.current_device()
    err = _lib().minmm_launch(
        dev, W_own.data_ptr(), W_part.data_ptr(), R, W_part.shape[0], cw,
        col_lo, col_hi, int(diag), row_base, col_base, out.data_ptr(),
        faults(W_own.device).data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"minmm kernel launch failed: CUDA error {err}")
    minmm.launches += 1
    minmm.rows += R
    minmm.rows_by_cw[cw] = minmm.rows_by_cw.get(cw, 0) + R
    return out


minmm.launches = minmm.rows = 0
minmm.rows_by_cw = {}
