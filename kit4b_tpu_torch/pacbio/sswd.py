"""Batched banded affine-gap Smith-Waterman, the port of
kit4b_tpu/pacbio/sswd.py.

A batch of (probe, target) pairs is aligned in a band of W target columns
that follows the diagonal target column = probe row + diag0 and slides one
column a probe row. Scoring is CSSW::SetScores' (pacbiokit4b/SSW.cpp:331):
match/mismatch, affine gaps costing `gap_open` for the first base and
`gap_ext` for each later one, local (scores floor at 0, traceback from the
peak). The scan and the traceback run on the device, in the hand CUDA
kernels of csrc/sw.cu on the card or their plain PyTorch versions on the
CPU (kernels/sw.py, which documents the pointer byte); only the op codes,
the coordinates and the match counts come back to the host, which
collapses the ops into runs as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..kernels.sw import NEG, sw_scan, sw_scan_plain, sw_traceback, \
    traceback_plain

__all__ = ["NEG", "SWScores", "SWAlignment", "banded_sw_batch", "sw_oracle",
           "sw_scan_plain", "traceback_plain"]


@dataclass(frozen=True)
class SWScores:
    """CSSW::SetScores equivalent (SSW.h:16-20)."""
    match: int = 1
    mismatch: int = -1
    gap_open: int = -3
    gap_ext: int = -1


@dataclass
class SWAlignment:
    score: int
    p_start: int          # aligned probe range [p_start, p_end)
    p_end: int
    t_start: int          # aligned target range [t_start, t_end)
    t_end: int
    ops: list             # [(op, length)] op in "M D I" probe-major
    matches: int = 0
    mismatches: int = 0


def banded_sw_batch(probes: np.ndarray, plens: np.ndarray,
                    targets: np.ndarray, tlens: np.ndarray,
                    diag0: np.ndarray, *, band: int = 256,
                    scores: SWScores = SWScores(),
                    traceback: bool = True,
                    device: str | torch.device = "cuda"):
    """Align each (probe[b], target[b]) pair in a band of width `band`
    centered on target_col = probe_row + diag0[b], on `device`. Arrays are
    code matrices padded with 0x0F. Returns list[SWAlignment] (ops empty
    when traceback=False)."""
    dev = resolve(device)
    B, Lp = probes.shape
    W = band
    # the JAX package pads both lengths to multiples of 512 for its compile
    # cache; the walk's length limit L_OPS = Lp + W follows the padded Lp,
    # so the port pads the same way
    Lp_p = -(-max(Lp, 1) // 512) * 512
    Lt_p = -(-max(targets.shape[1], 1) // 512) * 512
    if Lp_p != Lp:
        probes = np.pad(probes, ((0, 0), (0, Lp_p - Lp)),
                        constant_values=0x0F)
    if Lt_p != targets.shape[1]:
        targets = np.pad(targets, ((0, 0), (0, Lt_p - targets.shape[1])),
                         constant_values=0x0F)
    Lp = Lp_p

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)
    p_d, t_d = up(probes, np.uint8), up(targets, np.uint8)
    d0_d = up(diag0, np.int32)
    best, bi, bk, ptrs = sw_scan(
        p_d, t_d, up(plens, np.int32), up(tlens, np.int32), d0_d, W=W,
        match=scores.match, mismatch=scores.mismatch,
        gap_open=scores.gap_open, gap_ext=scores.gap_ext,
        traceback=traceback)
    if not traceback:
        best = best.cpu().numpy()
        return [SWAlignment(int(best[b]), 0, 0, 0, 0, []) for b in range(B)]
    L_OPS = Lp + W
    res = sw_traceback(ptrs, p_d, t_d, best, bi, bk, d0_d, W=W, L_OPS=L_OPS)
    del ptrs
    best, bi, bk = (x.cpu().numpy() for x in (best, bi, bk))
    OPS, NN, PS, TS, NM, NMM = (x.cpu().numpy() for x in res)
    out = []
    opc = {1: "M", 2: "D", 3: "I"}
    for b in range(B):
        sc = int(best[b])
        if sc <= 0:
            out.append(SWAlignment(0, 0, 0, 0, 0, []))
            continue
        rops = OPS[b, :int(NN[b])][::-1]
        ops = []
        if len(rops):
            bnd = np.nonzero(np.concatenate(
                [[True], rops[1:] != rops[:-1]]))[0]
            lens = np.diff(np.concatenate([bnd, [len(rops)]]))
            ops = [(opc[int(rops[j])], int(ln))
                   for j, ln in zip(bnd, lens)]
        i_end = int(bi[b])
        c_end = int(diag0[b]) + i_end + int(bk[b]) - W // 2
        out.append(SWAlignment(sc, int(PS[b]), i_end + 1, int(TS[b]),
                               c_end + 1, ops, int(NM[b]), int(NMM[b])))
    return out


def sw_oracle(p: np.ndarray, t: np.ndarray,
              scores: SWScores = SWScores()) -> int:
    """Naive full-matrix affine local-alignment score (host numpy), the
    check of the banded engine where the band holds the whole alignment."""
    Lp, Lt = len(p), len(t)
    H = np.zeros((Lp + 1, Lt + 1), np.int32)
    E = np.full((Lp + 1, Lt + 1), int(NEG), np.int32)
    F = np.full((Lp + 1, Lt + 1), int(NEG), np.int32)
    best = 0
    for i in range(1, Lp + 1):
        for j in range(1, Lt + 1):
            E[i, j] = max(H[i - 1, j] + scores.gap_open,
                          E[i - 1, j] + scores.gap_ext)
            F[i, j] = max(H[i, j - 1] + scores.gap_open,
                          F[i, j - 1] + scores.gap_ext)
            s = scores.match if p[i - 1] == t[j - 1] else scores.mismatch
            H[i, j] = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)
