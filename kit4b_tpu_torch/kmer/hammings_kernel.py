"""Exhaustive genome-wide K-mer Hamming distances by offset sweeps.

Port of kit4b_tpu/kmer/hammings_kernel.py, the legacy engine that
`hammings_exhaustive(legacy_sweep=True, use_kernel=True)` runs. Each sweep
takes one own sequence and one partner sequence and, for every own window
start i, the minimum window Hamming distance to the partner windows at
offsets d >= d_lo to its right (`kernels.sweep`: the CUDA kernel on the
card, its plain PyTorch version on the CPU). Four sweeps cover every pair
orientation:

  sense     : (own = g,     partner = g)      d >= 1, partner to the right
              (own = rev g, partner = rev g)  d >= 1, partner to the left
  antisense : (own = g,     partner = rc)     d >= 0
              (own = rev g, partner = rev rc) d >= 0

A reversed sweep's start i' is the window that starts at G - K - i' in g
(hamming(rev a, rev b) == hamming(a, b)). Windows that hold a sentinel
(code >= 5) never count.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..kernels.sweep import BIG, MAX_K, sweep


def hammings_exhaustive_kernel(genome_seq: np.ndarray, K: int, *,
                               antisense: bool = True,
                               device: str | torch.device = "cuda"
                               ) -> np.ndarray:
    """Min window-Hamming per window start (uint16 [G]; 0xFFFF where no
    valid K-mer). K <= 25.

    The JAX engine's `tile` and `span` only set the TPU kernel's blocking
    and never change the result, so the port takes neither."""
    if K > MAX_K:
        raise ValueError(f"kernel supports K <= {MAX_K}, got {K}")
    dev = resolve(device)
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    nk = G - K + 1
    if nk <= 0:
        return np.zeros(0, np.uint16)
    rc = np.where(g[::-1] < 4, 3 - g[::-1], g[::-1]).astype(np.uint8)
    grev = g[::-1].copy()
    rcrev = rc[::-1].copy()

    def codes(a):
        return torch.from_numpy(a).to(dev)

    gt, grevt = codes(g), codes(grev)
    fwd = sweep(gt, gt, K=K, G_valid=G, d_lo=1)
    rev = sweep(grevt, grevt, K=K, G_valid=G, d_lo=1)
    if antisense:
        fwd = torch.minimum(fwd, sweep(gt, codes(rc), K=K, G_valid=G, d_lo=0))
        rev = torch.minimum(rev, sweep(grevt, codes(rcrev), K=K, G_valid=G,
                                       d_lo=0))
    fwd[:nk] = torch.minimum(fwd[:nk], rev[:nk].flip(0))
    h = fwd.cpu().numpy()
    out = np.where(h >= BIG, 0xFFFF, h).astype(np.uint16)
    out[nk:] = 0xFFFF
    return out
