"""Exhaustive genome-wide K-mer Hamming distances as max-match products.

Port of kit4b_tpu/kmer/hammings_mxu.py. Every K-mer window i becomes a
one-hot int8 row  W[i, 5k+b] = [genome[i+k] == b]  (5 channels per base, so
N == N counts as a match; width 5K padded to a multiple of 128). The match
count of windows i and j is W[i] . W[j], and the minimum Hamming distance of
window i is K minus its best match over all partners: the other sense
windows (self pair masked) and, for antisense, every window of the reverse
complement. The max-match product runs in `kernels.minmm`: the CUDA kernel
on the card, its plain PyTorch version on the CPU.

Windows that hold a sentinel (any code >= 5) get an all-zero row, which
never under-reports a true minimum, and their outputs are masked to 0xFFFF.
Node partitioning (hammings -n/-N) splits the partner spans; per-node
results merge with an elementwise min.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..dna import BASE_EOG
from ..kernels.minmm import NEG, minmm

OUT_BIG = np.uint16(0xFFFF)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_w(ext: torch.Tensor, *, K: int, Gp: int, G: int,
            rc: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Window one-hot matrix W [Gp, 128*ceil(5K/128)] int8 and window
    validity [Gp] bool, on ext's device; port of `_build_w` and
    `_window_onehot_dev`. ext is the genome's uint8 codes padded with EOG to
    Gp + K. With rc the windows are those of the reverse complement (codes
    < 4 complemented, the genome reversed, padded with EOG again).

    Channel c is base position c // 5 and code c % 5; channels >= 5K are
    zero. A window is valid when it holds no sentinel and starts before
    G - K + 1; invalid rows are zero."""
    if rc:
        grev = ext[:G].flip(0)
        c = torch.where(grev < 4, 3 - grev, grev)
        ext = torch.cat([c, torch.full((Gp + K - G,), BASE_EOG, dtype=c.dtype,
                                       device=c.device)])
    C = _round_up(5 * K, 128)
    win = torch.stack([ext[k:k + Gp] for k in range(K)], dim=1)   # [Gp, K]
    codes = torch.arange(5, dtype=ext.dtype, device=ext.device)
    sent = (ext >= 5).to(torch.int32)
    cs = torch.cat([torch.zeros(1, dtype=torch.int32, device=ext.device),
                    torch.cumsum(sent, 0, dtype=torch.int32)])
    nbad = cs[K:K + Gp] - cs[:Gp]
    idx = torch.arange(Gp, device=ext.device)
    valid = (nbad == 0) & (idx < G - K + 1)
    W = torch.zeros((Gp, C), dtype=torch.int8, device=ext.device)
    W[:, :5 * K] = (win[:, :, None] == codes).reshape(Gp, 5 * K) \
        & valid[:, None]
    return W, valid


def hammings_exhaustive_mxu(genome_seq: np.ndarray, K: int, *,
                            antisense: bool = True,
                            node: int = 0, numnodes: int = 1,
                            T: int = 2048, S: int = 1024,
                            row_chunk: int = 1 << 21,
                            device: str | torch.device = "cuda") -> np.ndarray:
    """Min window-Hamming per position (uint16 [G]; 0xFFFF where no valid
    window). Node n of N takes partner spans [n*n_spans//N, (n+1)*n_spans//N)
    of S columns; partials merge with an elementwise min (ePMmerge).

    The genome is padded to Gp, a multiple of max(T, S). W (and Wrc for
    antisense) stay resident on `device`; own rows go through in row_chunk
    slices (rounded to T), the last one overlapping its predecessor."""
    dev = resolve(device)
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    nk = G - K + 1
    out = np.full(G, OUT_BIG, np.uint16)
    if nk <= 0:
        return out

    blk = max(T, S)
    Gp = _round_up(max(G, blk), blk)
    n_spans = Gp // S
    lo = (node * n_spans) // numnodes
    hi = ((node + 1) * n_spans) // numnodes
    cnt = hi - lo
    if cnt <= 0:
        return out

    ext = torch.from_numpy(np.concatenate(
        [g, np.full(Gp + K - G, BASE_EOG, np.uint8)])).to(dev)
    W, valid = build_w(ext, K=K, Gp=Gp, G=G, rc=False)
    parts = [(W, True)]
    if antisense:
        Wrc, _ = build_w(ext, K=K, Gp=Gp, G=G, rc=True)
        parts.append((Wrc, False))
    R = min(_round_up(Gp, T), _round_up(row_chunk, T))
    maxm = np.full(Gp, NEG, np.int32)
    for rb in range(0, Gp, R):
        if rb + R > Gp:
            rb = Gp - R       # overlap tail chunk; max is idempotent
        mm = None
        for W_part, diag in parts:
            m = minmm(W[rb:rb + R], W_part, diag=diag, span_lo=lo,
                      span_cnt=cnt, S=S, row_base=rb)
            mm = m if mm is None else torch.maximum(mm, m)
        maxm[rb:rb + R] = mm.cpu().numpy()
        if rb + R >= Gp:
            break
    hv = valid.cpu().numpy()
    nvalid = int(hv.sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        # no partner exists; all-zero invalid/padded rows would report K
        return out
    h = np.where(hv[:G], np.minimum(K - maxm[:G], int(OUT_BIG)),
                 int(OUT_BIG))
    return h.astype(np.uint16)
