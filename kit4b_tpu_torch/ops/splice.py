"""Splice-junction alignment: two-segment rescue for RNA-seq reads.

Capability parity with CSfxArray::LocateSpliceJuncts (SfxArray.cpp via
KAligner.cpp AlignReads: junction gap <= 100Kbp, canonical donor/acceptor
scoring, unique junctions only). The model is a read split s whose 5'
segment matches at locus pa and 3' segment at locus pb = pa + gap:

    cost(s) = preA[s] + (sufB[L] - sufB[s])

with preA the prefix mismatch cumsum against genome[pa:] and sufB the
cumsum against genome[pb - s0 ...] — evaluated over candidate locus PAIRS
drawn from the multiloci hits the substitutions-only pass already collected
(5'-side seeds anchor pa, 3'-side seeds anchor pb). Canonical GT..AG
junctions get preference (the reference scores canonical sites higher).

A copy of kit4b_tpu/ops/splice.py (host numpy), held to it by
tests/test_torch_rehomed.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_SPLICE_LEN = 100_000     # cMaxJunctLen analog
MAX_SPLICE_MM = 2            # cMaxJunctAlignMM analog
MIN_INTRON = 20


@dataclass
class SpliceHit:
    pos: int          # genome start of 5' segment
    strand: int
    split: int        # read offset of the junction
    gap: int          # intron length (genome bases skipped)
    mm: int
    canonical: bool

    def cigar(self, read_len: int) -> str:
        return f"{self.split}M{self.gap}N{read_len - self.split}M"


def find_splices(genome: np.ndarray, reads: np.ndarray,
                 cand_pos: np.ndarray, cand_strand: np.ndarray,
                 *, max_gap: int = MAX_SPLICE_LEN,
                 min_gap: int = MIN_INTRON,
                 max_mm: int = MAX_SPLICE_MM,
                 min_seg: int = 12) -> list:
    """Best spliced alignment per read from candidate locus pairs.

    reads [B, L] oriented codes; cand_pos/cand_strand [B, C]. Returns
    SpliceHit or None per read (unique best required; canonical junctions
    win ties against non-canonical)."""
    INT32_MAX = np.iinfo(np.int32).max
    B, L = reads.shape
    C = cand_pos.shape[1]
    G = len(genome)
    # base codes: G=2, T=3, A=0  (donor GT at 5' of intron, acceptor AG at 3')
    out = []
    for b in range(B):
        r = reads[b]
        cands = []
        for c in range(C):
            p = int(cand_pos[b, c])
            if p != INT32_MAX and 0 <= p and p + L <= G:
                cands.append(p)
        cands = sorted(set(cands))
        best = None
        best_key = None
        n_best = 0
        for i, pa in enumerate(cands):
            wa = genome[pa: pa + L]
            pre = np.concatenate(
                [[0], np.cumsum((r != wa) | (r >= 4) | (wa >= 4))])
            for pb in cands:
                gap0 = pb - pa
                if gap0 <= 0:
                    continue
                # the 3' segment aligned at pb means read[s:] matches
                # genome[pb + s:]; intron length = gap0
                if not (min_gap <= gap0 <= max_gap):
                    continue
                if pb + L > G:
                    continue
                wb = genome[pb: pb + L]
                suf = np.concatenate(
                    [[0], np.cumsum((r != wb) | (r >= 4) | (wb >= 4))])
                costs = pre[: L + 1] + (suf[L] - suf[: L + 1])
                sl = slice(min_seg, L - min_seg + 1)
                if sl.start >= sl.stop:
                    continue
                sidx = int(np.argmin(costs[sl])) + min_seg
                cost = int(costs[sidx])
                if cost > max_mm:
                    continue
                don = genome[pa + sidx: pa + sidx + 2]
                acc = genome[pb + sidx - 2: pb + sidx]
                canonical = (len(don) == 2 and len(acc) == 2
                             and don[0] == 2 and don[1] == 3
                             and acc[0] == 0 and acc[1] == 2)
                key = (cost, 0 if canonical else 1)
                cand = (cost, pa, sidx, gap0, canonical)
                if best_key is None or key < best_key:
                    best, best_key, n_best = cand, key, 1
                elif key == best_key and (cand[1], cand[2], cand[3]) != (
                        best[1], best[2], best[3]):
                    n_best += 1
        if best is None or n_best != 1:
            out.append(None)
        else:
            cost, pa, sidx, gap0, canonical = best
            out.append(SpliceHit(pa, int(cand_strand[b, 0]), sidx, gap0,
                                 cost, canonical))
    return out
