"""Plain reference of one exhaustive hammings node at given rows.

`node_rows_min` is `hammings -K -n N -N n` (exhaustive mode, ngskit4b
hammings ePMdefault with manual node partitioning) at int64 query
positions, for genomes of any length, past 2^31 included: a window counts
only if it holds no separator (code 5 or more) and starts at most G - K;
N matches N; the partner windows are the node's share of partner spans,
of both strands (the reverse complement's windows), the query's own sense
window left out; the answer is the least distance, at most K, and 0xFFFF
where the query window does not count.

It builds partner windows only from the node's span, as one-hot rows
multiplied in blocks: float16 on the card (exact up to 2,048), int32 on
the CPU. It imports nothing of the program and reads only the genome
codes the benchmark made. A copy, kept apart from `hammings.py` beside
it, so that each cell's yardstick stays as it was accepted.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 0xFFFF
SENTINEL = 5
EOG = 0x0F


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


def sense_codes(seq: np.ndarray, a: int, b: int) -> np.ndarray:
    """Codes of the genome at positions [a, b), EOG past its end."""
    out = np.full(b - a, EOG, np.uint8)
    part = seq[a:min(b, len(seq))]
    out[:len(part)] = part
    return out


def antisense_codes(seq: np.ndarray, a: int, b: int) -> np.ndarray:
    """Codes of the reverse complement at positions [a, b), EOG past its
    end: position t holds the complement of genome position G - 1 - t."""
    G = len(seq)
    t = np.arange(a, b, dtype=np.int64)
    src = seq[np.clip(G - 1 - t, 0, G - 1)]
    return np.where(t < G, np.where(src < 4, 3 - src, src),
                    EOG).astype(np.uint8)


def _one_hot(win: torch.Tensor, dt) -> torch.Tensor:
    oh = win[..., None] == torch.arange(5, device=win.device,
                                        dtype=win.dtype)
    return oh.reshape(*win.shape[:-1], -1).to(dt)


def _window_ok(codes: np.ndarray, K: int, n: int) -> np.ndarray:
    """[n] bool: codes[j:j + K] holds no separator."""
    bad = np.concatenate([[0], np.cumsum(codes >= SENTINEL)])
    return (bad[K:K + n] - bad[:n]) == 0


def node_rows_min(seq: np.ndarray, K: int, pos: np.ndarray, node: int,
                  numnodes: int, antisense: bool, device, *, T: int = 2048,
                  S: int = 1024, block: int = 1 << 15) -> np.ndarray:
    """Exhaustive mode's node partial at int64 positions `pos` (uint16
    [P]); T and S as `node_columns` takes them."""
    dev = torch.device(device)
    dt = torch.float16 if dev.type == "cuda" else torch.int32
    G = len(seq)
    nk = G - K + 1
    pos = np.asarray(pos, np.int64)
    win = np.stack([sense_codes(seq, int(p), int(p) + K) for p in pos]) \
        if len(pos) else np.zeros((0, K), np.uint8)
    valid = (pos < nk) & ~(win >= SENTINEL).any(1)
    Q = _one_hot(torch.from_numpy(win).to(dev), dt)
    p = torch.from_numpy(pos).to(dev)
    best = torch.full((len(pos),), K + 1, dtype=torch.int32, device=dev)
    _, c0, c1 = node_columns(G, node, numnodes, T, S)
    hi = min(c1, nk)
    lane = np.arange(K)
    strands = [(sense_codes, True)] + [(antisense_codes, False)] * antisense
    for codes_of, sense in strands:
        for j0 in range(c0, hi, block):
            j1 = min(j0 + block, hi)
            codes = codes_of(seq, j0, j1 + K - 1)
            n = j1 - j0
            ok = torch.from_numpy(_window_ok(codes, K, n)).to(dev)
            cw = torch.from_numpy(codes[np.arange(n)[:, None] + lane]).to(dev)
            m = (Q @ _one_hot(cw, dt).T).round().to(torch.int32) \
                if dt == torch.float16 else Q @ _one_hot(cw, dt).T
            d = torch.where(ok[None], K - m, K + 1)
            if sense:
                j = torch.arange(j0, j1, device=dev)
                d = torch.where(p[:, None] == j[None], K + 1, d)
            best = torch.minimum(best, d.amin(1))
    d = best.cpu().numpy().astype(np.int64)
    return np.where(valid, np.minimum(d, K), BIG).astype(np.uint16)
