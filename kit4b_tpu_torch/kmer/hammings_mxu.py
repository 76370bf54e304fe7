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
results merge with an elementwise min. A node (`HammingsNode`) holds the
genome's codes and the one-hot windows of its own partner span, of both
strands, on the card, and streams its own rows in blocks, each block's
one-hot built from the codes, used and freed: a genome past 2^31 positions
(GRCh38's 3.09 Gbp) needs 3.09 GB resident, not its 395 GB of windows.
A block's maxima become uint16 distances on the device (K - max, capped
at 0xFFFF; 0xFFFF for invalid rows) and reach the host in one copy of 2
bytes a row through a pinned buffer the node keeps; the kernel's count of
own-row groups that are not 2:4-sparse comes with them, and a block that
has any raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..dna import BASE_EOG
from ..kernels.minmm import TILE, faults, minmm, raise_on_faults
from ..utils.runtime import span

OUT_BIG = np.uint16(0xFFFF)
BLOCK_ROWS = 1 << 24      # own rows a block


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_valid(codes: torch.Tensor, j0: int, n: int, *, K: int,
                 G: int) -> torch.Tensor:
    """[n] bool: the window at j0 + i holds no sentinel (code >= 5) in
    codes[i:i + K] and starts before G - K + 1."""
    sent = (codes[:n + K - 1] >= 5).to(torch.int32)
    cs = torch.cat([torch.zeros(1, dtype=torch.int32, device=codes.device),
                    torch.cumsum(sent, 0, dtype=torch.int32)])
    valid = cs[K:K + n] == cs[:n]
    valid[max(0, min(n, G - K + 1 - j0)):] = False
    return valid


def onehot_windows(codes: torch.Tensor, j0: int, n: int, *, K: int,
                   G: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One-hot rows [n, 128*ceil(5K/128)] int8 and validity [n] bool of the
    windows starting at j0 .. j0 + n - 1 of one strand, from that strand's
    codes at positions [j0, j0 + n + K - 1). Channel c is base position
    c // 5 and code c % 5; channels >= 5K are zero. A window is valid when
    it holds no sentinel (code >= 5) and starts before G - K + 1; invalid
    rows are zero. One base position at a time, so no [n, K] array is
    made."""
    C = _round_up(5 * K, 128)
    valid = window_valid(codes, j0, n, K=K, G=G)
    W = torch.zeros((n, C), dtype=torch.int8, device=codes.device)
    Wk = W[:, :5 * K].view(n, K, 5)
    base = torch.arange(5, dtype=codes.dtype, device=codes.device)
    for k in range(K):
        Wk[:, k] = (codes[k:k + n, None] == base) & valid[:, None]
    return W, valid


def rc_codes(ext: torch.Tensor, G: int, a: int, b: int) -> torch.Tensor:
    """Codes at positions [a, b) of the reverse complement of the genome
    ext[:G] (codes < 4 complemented, the genome reversed), EOG past G."""
    lo, hi = max(G - b, 0), max(G - a, 0)
    seg = ext[lo:hi].flip(0)
    seg = torch.where(seg < 4, 3 - seg, seg)
    return torch.cat([seg, torch.full((b - a - len(seg),), BASE_EOG,
                                      dtype=seg.dtype, device=seg.device)])


def build_w(ext: torch.Tensor, *, K: int, Gp: int, G: int,
            rc: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Window one-hot matrix W [Gp, 128*ceil(5K/128)] int8 and window
    validity [Gp] bool, on ext's device; port of `_build_w` and
    `_window_onehot_dev`. ext is the genome's uint8 codes padded with EOG to
    Gp + K. With rc the windows are those of the reverse complement (codes
    < 4 complemented, the genome reversed, padded with EOG again); see
    `onehot_windows`."""
    codes = rc_codes(ext, G, 0, Gp + K) if rc else ext
    return onehot_windows(codes, 0, Gp, K=K, G=G)


class HammingsNode:
    """One node of the exhaustive engine (hammings -n N -N node+1),
    prepared once: the genome's codes on the device, and the one-hot
    windows of the node's partner columns [c0, c1) (spans [lo, hi) of S
    columns of the genome padded to Gp, a multiple of max(T, S)), of the
    sense strand and, with antisense, of the reverse complement. `rows`
    then gives the distances of any own-row range in one block, and
    `rows_in_blocks` in blocks of BLOCK_ROWS.

    Counters, beside `minmm.launches`, `minmm.rows` and
    `minmm.rows_by_cw`: `own_rows_built`
    (own one-hot rows built, padding to 128 included),
    `partner_cols_built` (partner one-hot rows built, both strands) and
    `bytes_collected` (bytes of distances `rows` returns to the host, 2 a
    row)."""

    own_rows_built = partner_cols_built = bytes_collected = 0

    def __init__(self, genome_seq: np.ndarray, K: int, *,
                 antisense: bool = True, node: int = 0, numnodes: int = 1,
                 T: int = 2048, S: int = 1024,
                 device: str | torch.device = "cuda"):
        self.dev = resolve(device)
        g = np.ascontiguousarray(genome_seq, np.uint8)
        G = len(g)
        self.G, self.K, self.S = G, K, S
        blk = max(T, S)
        self.Gp = _round_up(max(G, blk), blk)
        n_spans = self.Gp // S
        self.lo = (node * n_spans) // numnodes
        self.cnt = ((node + 1) * n_spans) // numnodes - self.lo
        self.c0, self.c1 = self.lo * S, (self.lo + self.cnt) * S
        self.C = _round_up(5 * K, 128)
        self.parts: list[tuple[torch.Tensor, bool]] = []
        self.pinned: torch.Tensor | None = None
        if G - K + 1 <= 0 or self.cnt <= 0:
            return
        with span("hammings.upload"):
            # own rows of a block are padded to TILE, reading up to
            # Gp + TILE + K - 1 codes
            self.ext = torch.full((self.Gp + TILE + K,), BASE_EOG,
                                  dtype=torch.uint8, device=self.dev)
            self.ext[:G].copy_(torch.from_numpy(g))
        if not antisense and self._n_valid(2) < 2:
            return      # no partner exists; zero rows would report K
        with span("hammings.partners"):
            n = self.c1 - self.c0
            e = self.c1 + K - 1
            self.parts.append((onehot_windows(
                self.ext[self.c0:e], self.c0, n, K=K, G=G)[0], True))
            if antisense:
                self.parts.append((onehot_windows(
                    rc_codes(self.ext, G, self.c0, e), self.c0, n, K=K,
                    G=G)[0], False))
            HammingsNode.partner_cols_built += n * len(self.parts)

    def _n_valid(self, cap: int) -> int:
        """Valid sense windows, counted up to `cap`, in blocks."""
        n, K = 0, self.K
        for a in range(0, self.G - K + 1, BLOCK_ROWS):
            b = min(a + BLOCK_ROWS, self.G - K + 1)
            n += int(window_valid(self.ext[a:b + K - 1], a, b - a, K=K,
                                  G=self.G).sum())
            if n >= cap:
                break
        return n

    def rows(self, r0: int, r1: int) -> np.ndarray:
        """uint16 [r1 - r0] least distances of own rows [r0, r1), 0 <= r0
        <= r1 <= Gp (0xFFFF where the window does not count), by one
        minmm launch a strand over the block padded to TILE rows. The
        distances are made on the device and copied to the host once; the
        array returned is the caller's own."""
        if not self.parts or r1 <= r0:
            return np.full(r1 - r0, OUT_BIG, np.uint16)
        K, m = self.K, r1 - r0
        with span("hammings.rows"):
            n = _round_up(m, TILE)
            with span("hammings.onehot"):
                W, valid = onehot_windows(self.ext[r0:r0 + n + K - 1], r0, n,
                                          K=K, G=self.G)
                HammingsNode.own_rows_built += n
            ms = [minmm(W, Wp, diag=diag, span_lo=self.lo,
                        span_cnt=self.cnt, S=self.S, row_base=r0,
                        col_base=self.c0) for Wp, diag in self.parts]
            del W
            with span("hammings.collect"):
                mm = ms[0] if len(ms) == 1 else torch.maximum(*ms)
                with span("hammings.fold"):
                    # a row whose every pair is masked reads NEG: K - NEG caps
                    # to 0xFFFF
                    d = torch.where(valid[:m], (K - mm[:m]).clamp_(
                        max=int(OUT_BIG)), int(OUT_BIG)).to(torch.uint16)
                HammingsNode.bytes_collected += 2 * m
                return self._to_host(d)

    def rows_in_blocks(self, r0: int, r1: int) -> np.ndarray:
        """`rows` of own rows [r0, r1), BLOCK_ROWS at a time, into one new
        uint16 [r1 - r0] array."""
        out = np.empty(r1 - r0, np.uint16)
        for a in range(r0, r1, BLOCK_ROWS):
            b = min(a + BLOCK_ROWS, r1)
            out[a - r0:b - r0] = self.rows(a, b)
        return out

    def _to_host(self, d: torch.Tensor) -> np.ndarray:
        """A new numpy array of the distances d; off the CPU through the
        node's pinned buffer, sized at first for min(Gp, BLOCK_ROWS) rows
        and grown when a larger block comes, with the kernel's fault count
        (`kernels.minmm.faults`) in the same sync: raises where it is not
        0."""
        if d.device.type == "cpu":
            return d.numpy()
        if self.pinned is None or len(self.pinned) < len(d):
            self.pinned = None
            self.pinned = torch.empty(max(len(d), min(self.Gp, BLOCK_ROWS)),
                                      dtype=torch.uint16, pin_memory=True)
            self.pinned_faults = torch.empty(1, dtype=torch.int32,
                                             pin_memory=True)
        buf = self.pinned[:len(d)]
        buf.copy_(d, non_blocking=True)
        self.pinned_faults.copy_(faults(d.device), non_blocking=True)
        torch.cuda.current_stream(d.device).synchronize()
        raise_on_faults(int(self.pinned_faults[0]), d.device)
        return buf.numpy().copy()


def hammings_exhaustive_mxu(genome_seq: np.ndarray, K: int, *,
                            antisense: bool = True,
                            node: int = 0, numnodes: int = 1,
                            T: int = 2048, S: int = 1024,
                            device: str | torch.device = "cuda") -> np.ndarray:
    """Min window-Hamming per position (uint16 [G]; 0xFFFF where no valid
    window). Node n of N takes partner spans [n*n_spans//N, (n+1)*n_spans//N)
    of S columns; partials merge with an elementwise min (ePMmerge).

    A `HammingsNode` over the genome padded to Gp, a multiple of max(T, S),
    then all its Gp own rows in blocks of BLOCK_ROWS: a genome up to
    BLOCK_ROWS runs in one launch a strand, the kernel's blocks filling
    whole waves but for the last, and no row runs twice."""
    with span("hammings.sweep"):
        G = len(genome_seq)
        if G - K + 1 <= 0:
            return np.full(G, OUT_BIG, np.uint16)
        eng = HammingsNode(genome_seq, K, antisense=antisense, node=node,
                           numnodes=numnodes, T=T, S=S, device=device)
        return eng.rows_in_blocks(0, eng.Gp)[:G]
