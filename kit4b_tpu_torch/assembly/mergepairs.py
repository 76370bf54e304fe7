"""mergeoverlaps: merge overlapping PE short-insert pairs into SE reads.
The port's copy of kit4b_tpu/assembly/mergepairs.py.

Capability parity with CMergeReadPairs (ngskit4b/MergeReadPairs.cpp): when a
fragment is shorter than the two read lengths combined, mate 1's 3' end
overlaps the reverse complement of mate 2; the merged SE read covers the full
fragment. Overlap chosen by the lowest-mismatch candidate scoring under a
subs budget; ambiguous or unoverlapped pairs stay paired.

Vectorized over the pair batch per candidate overlap length (NumPy; the
per-candidate compare is [N, o] elementwise).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io.fasta import SeqRecord


@dataclass
class MergeParams:
    min_overlap: int = 16
    max_subs_pct: int = 5     # allowed mismatches as % of overlap length


def merge_pairs(recs1: list, recs2: list, params: MergeParams | None = None):
    """Returns (merged SE records, kept (rec1, rec2) pairs, stats dict)."""
    p = params or MergeParams()
    merged: list[SeqRecord] = []
    kept: list[tuple] = []
    stats = {"pairs": 0, "merged": 0, "unmerged": 0}

    by_len: dict[tuple, list[int]] = {}
    for i, (r1, r2) in enumerate(zip(recs1, recs2)):
        by_len.setdefault((len(r1.codes), len(r2.codes)), []).append(i)

    for (L1, L2), idxs in by_len.items():
        m1 = np.stack([recs1[i].codes for i in idxs])
        m2rc = np.stack([dna.revcomp(recs2[i].codes) for i in idxs])
        n = len(idxs)
        max_o = min(L1, L2)
        best_o = np.zeros(n, np.int32)
        best_mm = np.full(n, 1 << 30, np.int32)
        n_ok = np.zeros(n, np.int32)
        for o in range(p.min_overlap, max_o + 1):
            mm = (m1[:, L1 - o:] != m2rc[:, :o]).sum(axis=1)
            limit = max(1, o * p.max_subs_pct // 100)
            ok = mm <= limit
            # normalized score prefers longer overlaps at equal rate
            better = ok & (mm * max_o < best_mm * o)
            best_o = np.where(better, o, best_o)
            best_mm = np.where(better, mm * max_o // np.maximum(o, 1),
                               best_mm)
            n_ok += ok
        for j, i in enumerate(idxs):
            stats["pairs"] += 1
            o = int(best_o[j])
            if o == 0:
                kept.append((recs1[i], recs2[i]))
                stats["unmerged"] += 1
                continue
            r1, r2 = recs1[i], recs2[i]
            rc2 = m2rc[j]
            # consensus over the overlap favors the higher-quality base;
            # without qualities, mate 1 wins (reference default)
            seq = np.concatenate([r1.codes, rc2[o:]])
            if r1.qual is not None and r2.qual is not None:
                q2 = r2.qual[::-1]
                ov1 = r1.codes[L1 - o:]
                ov2 = rc2[:o]
                use2 = q2[:o] > r1.qual[L1 - o:]
                seq[L1 - o: L1] = np.where(use2, ov2, ov1)
                qual = np.concatenate([
                    r1.qual[: L1 - o],
                    np.maximum(r1.qual[L1 - o:], q2[:o]), q2[o:]])
            else:
                qual = None
            merged.append(SeqRecord(r1.name, "merged", seq, qual))
            stats["merged"] += 1
    return merged, kept, stats
