"""Chimeric read trimming: align the best flank-trimmed read segment.

Capability parity with the reference's chimeric pass (SfxArray.cpp:7925-7933:
adaptive flank trim, minimum chimeric length as a percentage of the read).
For each candidate locus the longest contiguous read window whose mismatch
count stays within budget is found by a two-pointer sweep over the prefix
mismatch cumsum; flanks outside the window become SAM soft-clips.

A copy of kit4b_tpu/ops/chimeric.py (host numpy), held to it by
tests/test_torch_rehomed.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ChimericHit:
    pos: int          # genome start of the MATCHED segment
    strand: int
    trim5: int        # soft-clipped bases at read 5'
    trim3: int
    mm: int

    def cigar(self, read_len: int) -> str:
        mid = read_len - self.trim5 - self.trim3
        out = ""
        if self.trim5:
            out += f"{self.trim5}S"
        out += f"{mid}M"
        if self.trim3:
            out += f"{self.trim3}S"
        return out


def find_chimeric(genome: np.ndarray, reads: np.ndarray,
                  cand_pos: np.ndarray, cand_strand: np.ndarray,
                  *, min_chimeric_pct: int = 50,
                  subs_per_100: int = 5) -> list:
    """Best flank-trimmed alignment per read (unique best required)."""
    INT32_MAX = np.iinfo(np.int32).max
    B, L = reads.shape
    C = cand_pos.shape[1]
    G = len(genome)
    min_len = max(16, L * min_chimeric_pct // 100)
    out = []
    for b in range(B):
        r = reads[b]
        best = None
        best_key = None
        n_best = 0
        for c in range(C):
            p = int(cand_pos[b, c])
            if p == INT32_MAX or p < 0 or p + L > G:
                continue
            w = genome[p: p + L]
            mism = ((r != w) | (r >= 4) | (w >= 4)).astype(np.int32)
            cs = np.concatenate([[0], np.cumsum(mism)])
            # longest window [a, b) with mm <= budget(b-a)
            a = 0
            best_win = None
            for e in range(1, L + 1):
                while a < e:
                    wl = e - a
                    budget = max(1, wl * subs_per_100 // 100)
                    if cs[e] - cs[a] <= budget:
                        break
                    a += 1
                wl = e - a
                if wl >= min_len and (best_win is None or wl > best_win[1]):
                    best_win = (a, wl, int(cs[e] - cs[a]))
            if best_win is None:
                continue
            a0, wl, mm = best_win
            key = (-wl, mm)
            cand = (p, a0, wl, mm)
            if best_key is None or key < best_key:
                best, best_key, n_best = cand, key, 1
            elif key == best_key and cand[0] + cand[1] != best[0] + best[1]:
                n_best += 1
        if best is None or n_best != 1:
            out.append(None)
        else:
            p, a0, wl, mm = best
            out.append(ChimericHit(p + a0, int(cand_strand[b, 0]), a0,
                                   L - a0 - wl, mm))
    return out
