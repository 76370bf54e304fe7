"""Plain references of genome-wide minimum K-mer Hamming distances.

Both count, for each queried K-mer start, its mismatches against K-mer
windows of the genome by brute force: one-hot query windows times one-hot
partner windows, as plain matrix products in blocks of partners. They
import nothing of the program and read only the genome codes the
benchmark made.

`node_min` is `hammings -K -n N -N n` (exhaustive mode, ngskit4b
hammings ePMdefault with manual node partitioning): a window counts only
if it holds no separator (code 5 or more) and starts at most G - K; N
matches N; the partner windows are the node's share of partner spans, of
both strands (the reverse complement's windows), the query's own sense
window left out; the answer is the least distance, at most K, and 0xFFFF
where the query window does not count.

`restricted_true` is the true minimum that restricted mode (`hammings
-r`, ngskit4b ePMrestrict) approximates: over every window start in
[0, G - K] of both strands, a base that is N or a separator counting as a
mismatch, the query's own sense window left out. `restricted_rule` holds
an answer to the mode's guarantee: exact up to W - 1 mismatches, where W =
min(r + 1, K // lut_k) pigeonhole seeds of the index's lut_k bases fit in
K; at least the true minimum and at most r + 1 above that; r + 1 where
the true minimum is past r; 0 for a window with more than 4 Ns.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 0xFFFF
SENTINEL = 5


def node_columns(G: int, node: int, numnodes: int, T: int = 2048,
                 S: int = 1024) -> tuple[int, int, int]:
    """(padded length Gp, first, end) partner columns of node `node` (from
    0) of `numnodes`: Gp is G padded to a multiple of max(T, S), cut into
    Gp // S spans of S columns, and the node takes spans [node * n //
    numnodes, (node + 1) * n // numnodes)."""
    blk = max(T, S)
    Gp = -(-max(G, blk) // blk) * blk
    n = Gp // S
    return Gp, node * n // numnodes * S, (node + 1) * n // numnodes * S


def pick_lut_k(G: int) -> int:
    """The suffix index's seed width: about log4(G), clamped to [8, 13]."""
    k, g = 1, G
    while g >= 4:
        g >>= 2
        k += 1
    return max(8, min(13, k))


def _revcomp(seq: np.ndarray) -> np.ndarray:
    rev = seq[::-1]
    return np.where(rev < 4, 3 - rev, rev).astype(np.uint8)


def _one_hot(win: torch.Tensor, channels: int, dt) -> torch.Tensor:
    oh = win[..., None] == torch.arange(channels, device=win.device,
                                        dtype=win.dtype)
    return oh.reshape(*win.shape[:-1], -1).to(dt)


def _min_dist(seq: np.ndarray, K: int, pos: np.ndarray, cols: tuple,
              antisense: bool, channels: int, separators_valid: bool,
              device, block: int = 1 << 18) -> np.ndarray:
    """Least distance of each query window at `pos` to the partner windows
    starting in [cols[0], cols[1]) of the sense strand and, with
    antisense, of the reverse complement; own sense window left out.
    Partner windows holding a separator are left out unless
    `separators_valid`. Distances count the K - matches of `channels`-code
    one-hot rows. Returns int64 [P] (K + 1 where no partner counts)."""
    dev = torch.device(device)
    dt = torch.float16 if dev.type == "cuda" else torch.float32
    G = len(seq)
    nk = G - K + 1
    lane = torch.arange(K, device=dev)
    pad = np.full(K, 0x0F, np.uint8)
    fwd = torch.from_numpy(np.concatenate([seq, pad])).to(dev)
    p = torch.from_numpy(pos.astype(np.int64)).to(dev)
    Q = _one_hot(fwd[p[:, None] + lane], channels, dt)
    best = torch.full((len(pos),), K + 1, dtype=torch.int32, device=dev)
    strands = [(fwd, True)]
    if antisense:
        rc = torch.from_numpy(np.concatenate([_revcomp(seq), pad])).to(dev)
        strands.append((rc, False))
    lo, hi = cols[0], min(cols[1], nk)
    for src, sense in strands:
        bad = (src >= SENTINEL).to(torch.int32)
        cb = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(bad, 0, dtype=torch.int32)])
        for j0 in range(lo, hi, block):
            j = torch.arange(j0, min(j0 + block, hi), device=dev)
            win = src[j[:, None] + lane]
            m = (Q @ _one_hot(win, channels, dt).T).round().to(torch.int32)
            d = K - m
            if not separators_valid:
                ok = (cb[j + K] - cb[j]) == 0
                d = torch.where(ok[None], d, K + 1)
            if sense:
                d = torch.where(p[:, None] == j[None], K + 1, d)
            best = torch.minimum(best, d.amin(1))
    return best.cpu().numpy().astype(np.int64)


def node_min(seq: np.ndarray, K: int, pos: np.ndarray, node: int,
             numnodes: int, antisense: bool, device) -> np.ndarray:
    """Exhaustive mode's node partial at `pos` (uint16 [P])."""
    G = len(seq)
    _, c0, c1 = node_columns(G, node, numnodes)
    d = _min_dist(seq, K, pos, (c0, c1), antisense, 5, False, device)
    win = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([seq, np.full(K, 0x0F, np.uint8)]), K)[pos]
    valid = (pos < G - K + 1) & ~(win >= SENTINEL).any(1)
    return np.where(valid, np.minimum(d, K), BIG).astype(np.uint16)


def restricted_true(seq: np.ndarray, K: int, pos: np.ndarray,
                    antisense: bool, device) -> np.ndarray:
    """True minimum of restricted mode's measure at clean windows `pos`."""
    return _min_dist(seq, K, pos, (0, len(seq) - K + 1), antisense, 4,
                     True, device)


def restricted_rule(got: np.ndarray, true: np.ndarray, K: int,
                    max_hamming: int, lut_k: int) -> np.ndarray:
    """Per clean query: does the answer keep restricted mode's guarantee?"""
    W = min(max_hamming + 1, max(1, K // lut_k))
    capped = np.minimum(true, max_hamming + 1)
    return np.where(true <= W - 1, got == true,
                    (got >= capped) & (got <= max_hamming + 1))
