"""microInDel alignment: single-indel rescue for substitution-rejected reads.

Capability parity with CSfxArray::LocateInDels (ngskit4b/KAligner.cpp /
SfxArray.cpp:7895; microInDel <= 20 bp, subs clamped to cMaxMicroInDelMM):
the reference models exactly ONE insertion or deletion of size 1..D plus
substitutions, splitting the read into two matched segments (Seg0/Seg1).

That model needs no DP wavefront: for a candidate genome position,
  deletion of d: cost(s) = pre[s] + (S_d[L] - S_d[s])
  insertion of d: cost(s) = pre[s] + (T_d[L-d] - T_d[s])
where pre = prefix mismatch cumsum at shift 0, S_d compares read[i] vs
window[i+d], and T_d compares read[i+d] vs window[i]. The best (type, d,
split) is a min over ~2*D*L precomputed cumsums — fully vectorized over the
candidate batch (these are the reads the substitutions-only pass rejected,
so the batch is small and an elementwise formulation suffices).

A copy of kit4b_tpu/ops/indel.py (host numpy), held to it by
tests/test_torch_rehomed.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_MICROINDEL = 20          # cMaxMicroInDelLen
MAX_MICROINDEL_MM = 2        # cMaxMicroInDelMM analog (clamped subs budget)
BIG = np.int32(1 << 28)


@dataclass
class IndelHit:
    pos: int          # genome start of segment 0
    strand: int
    split: int        # read offset where the indel occurs
    indel_len: int    # >0
    is_insert: bool   # True: read has extra bases; False: genome does
    mm: int           # substitutions outside the indel

    def cigar(self, read_len: int) -> str:
        L = read_len
        s, d = self.split, self.indel_len
        if self.is_insert:
            right = L - s - d
            return f"{s}M{d}I{right}M" if right else f"{s}M{d}I"
        right = L - s
        return f"{s}M{d}D{right}M" if right else f"{s}M{d}D"


def find_indels(genome: np.ndarray, reads: np.ndarray,
                cand_pos: np.ndarray, cand_strand: np.ndarray,
                *, max_indel: int = MAX_MICROINDEL,
                max_mm: int = MAX_MICROINDEL_MM,
                min_seg: int = 8) -> list:
    """Best single-indel alignment per read.

    reads [B, L] codes ORIENTED per candidate strand handled by caller;
    cand_pos/cand_strand [B, C] (INT32_MAX-padded). Returns per-read
    IndelHit or None; requires a unique best (reference accepts only unique
    InDels). min_seg keeps both matched segments anchored (split not at the
    very ends).
    """
    INT32_MAX = np.iinfo(np.int32).max
    B, L = reads.shape
    C = cand_pos.shape[1]
    G = len(genome)
    D = max_indel
    out = []
    win_len = L + D
    for b in range(B):
        best = None
        best_cost = None
        n_best = 0
        for c in range(C):
            p = int(cand_pos[b, c])
            if p == INT32_MAX or p < 0 or p + win_len > G:
                continue
            r = reads[b]
            w = genome[p: p + win_len]
            bad_w = w >= 4
            pre = np.concatenate(
                [[0], np.cumsum((r != w[:L]) | (r >= 4) | bad_w[:L])])
            for d in range(1, D + 1):
                # deletion: genome has d extra bases after the split
                s_d = np.concatenate(
                    [[0], np.cumsum((r != w[d: d + L]) | (r >= 4)
                                    | bad_w[d: d + L])])
                costs = pre[:L + 1] + (s_d[L] - s_d[: L + 1])
                sl = slice(min_seg, L - min_seg + 1)
                sidx = int(np.argmin(costs[sl])) + min_seg
                cost = int(costs[sidx])
                for cand in ((cost, p, sidx, d, False),):
                    if cand[0] <= max_mm:
                        if best_cost is None or cand[0] < best_cost:
                            best, best_cost, n_best = cand, cand[0], 1
                        elif cand[0] == best_cost and (
                                cand[1], cand[2], cand[3]) != (
                                best[1], best[2], best[3]):
                            n_best += 1
                # insertion: read has d extra bases
                if L - d > 2 * min_seg:
                    t_d = np.concatenate(
                        [[0], np.cumsum((r[d:] != w[: L - d])
                                        | (r[d:] >= 4) | bad_w[: L - d])])
                    costs = pre[: L - d + 1] + (t_d[L - d]
                                                - t_d[: L - d + 1])
                    sl = slice(min_seg, L - d - min_seg + 1)
                    sidx = int(np.argmin(costs[sl])) + min_seg
                    cost = int(costs[sidx])
                    if cost <= max_mm:
                        cand = (cost, p, sidx, d, True)
                        if best_cost is None or cost < best_cost:
                            best, best_cost, n_best = cand, cost, 1
                        elif cost == best_cost and (
                                cand[1], cand[2], cand[3], cand[4]) != (
                                best[1], best[2], best[3], best[4]):
                            n_best += 1
        if best is None or n_best != 1:
            out.append(None)
        else:
            cost, p, sidx, d, is_ins = best
            out.append(IndelHit(p, int(cand_strand[b, 0]), sidx, d,
                                is_ins, cost))
    return out
