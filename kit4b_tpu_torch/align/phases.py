"""kalign post-alignment phases (reference CKAligner phase list): the
orphan splice and microInDel removal (KAligner.cpp:2406 / :2501).

A copy of that part of kit4b_tpu/align/phases.py. It works on the
materialised (rec, res) list form between kalign.align_records and
kalign.write_sam. The other phases (AutoTrimFlanks, PCR5PrimerCorrect,
loci constraints, multiloci assignment, the side files) are ROADMAP.md
queue A item 20.
"""
from __future__ import annotations

import re

from .kalign import NAR_ACCEPTED

NAR_ORPHAN_SPLICE = "orphan_splice"     # eNARSpliceJctn analog
NAR_ORPHAN_INDEL = "orphan_indel"       # eNARmicroInDel analog


def _junction(res) -> tuple | None:
    """(seg0_end, seg1_start) genome coords from a two-segment CIGAR
    (MNM splice / MDM deletion / MIM insertion), as the reference takes
    AdjEndLoci(Seg[0]) / AdjStartLoci(Seg[1])."""
    if not res.cigar:
        return None
    ops = re.findall(r"(\d+)([MIDNS])", res.cigar)
    gpos = res.pos
    seg_end = None
    for ln, op in ops:
        ln = int(ln)
        if op == "M":
            if seg_end is None:
                seg_end = gpos + ln          # end of first segment
            gpos += ln
        elif op in ("D", "N"):
            gpos += ln
        # I/S consume no genome
        if seg_end is not None and op in ("D", "N", "I"):
            return (seg_end, gpos if op != "I" else seg_end)
    return None


def remove_orphan_junctions(aligned: list, kind: str) -> int:
    """Demote accepted splice ('splice', CIGAR N) or microInDel ('indel',
    CIGAR I/D) reads whose junction is not supported by a second read
    within +/-3 bp on both junction coords. Mirrors the reference's
    adjacent-after-sort multiplicity test (KAligner.cpp:2454-2466) and its
    treat-as-unaligned demotion (:2470-2478). Returns demoted count."""
    want = "N" if kind == "splice" else "ID"
    juncts = []
    for i, (rec, res) in enumerate(aligned):
        if res.nar != NAR_ACCEPTED or not res.cigar:
            continue
        if not any(c in res.cigar for c in want):
            continue
        j = _junction(res)
        if j is not None:
            juncts.append((j[0], j[1], i))
    n_removed = 0
    nar_to = NAR_ORPHAN_SPLICE if kind == "splice" else NAR_ORPHAN_INDEL
    if len(juncts) == 1:
        _, res = aligned[juncts[0][2]]
        res.nar = nar_to
        return 1
    juncts.sort()
    supported = set()
    for a, b in zip(juncts, juncts[1:]):
        if abs(a[0] - b[0]) <= 3 and abs(a[1] - b[1]) <= 3:
            supported.add(a[2])
            supported.add(b[2])
    for _, _, i in juncts:
        if i not in supported:
            res = aligned[i][1]
            res.nar = nar_to
            n_removed += 1
    return n_removed
