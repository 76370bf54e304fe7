"""hrdx: homozygotic-region reduction of diploid assemblies, the port's
copy of kit4b_tpu/assembly/hrdx.py (host numpy: an index of the contigs
and an ungapped blitz, which touches no device).

Capability parity with `kit4bhrdx` (kit4bhrdx/HomozyReduce.cpp
CHomozyReduce): contigs assembled from a diploid genome contain pairs
of near-identical haplotype copies; regions of one contig that overlap
another contig with at most max_homozy_subs substitutions per 100 over
at least min_homozy_len bases are homozygous; short heterozygous gaps
(< min_het_len) flanked by homozygous regions are treated as homozygous
(kit4bhrdx.cpp -z/-Z/-k). A contig essentially covered by homozygous
overlap onto a longer contig is redundant and removed.

Overlap discovery reuses the blitz seed-chain engine over an in-memory
index of all contigs, concatenated without separators as the original
builds it, replacing the reference's per-thread suffix-array probe loops
(LocateOverlaidTarg).
"""
from __future__ import annotations

import numpy as np

from ..io.fasta import Genome


def reduce_homozygous(records: list, *, max_homozy_subs: int = 3,
                      min_homozy_len: int = 75, min_het_len: int = 30,
                      min_ctg_len: int = 100,
                      min_reduce_cover: float = 0.9) -> tuple[list, dict]:
    """Returns (kept SeqRecords, stats). A contig is dropped when >=
    min_reduce_cover of its length is homozygous with longer (or
    equal-length, later-named) contigs."""
    from ..align.blitz import blitz_align
    from ..index.sfx_index import SfxIndex

    recs = [r for r in records if len(r.codes) >= min_ctg_len]
    if not recs:
        return [], {"in": len(records), "kept": 0, "reduced": 0}
    names = [r.name for r in recs]
    lens = {r.name: len(r.codes) for r in recs}
    starts = np.cumsum([0] + [len(r.codes) for r in recs[:-1]])
    g = Genome(names, starts.astype(np.int64),
               np.array([len(r.codes) for r in recs], np.int64),
               np.concatenate([r.codes for r in recs]).astype(np.uint8))
    index = SfxIndex.build(g)
    hits = blitz_align(index, recs, stride=4, min_hits=3,
                       min_score=min_homozy_len,
                       max_hits_per_query=32)

    # homozygous spans per probe contig
    spans: dict[str, list] = {n: [] for n in names}
    for h in hits:
        if h.chrom == h.query:
            continue                       # self
        span = h.q_end - h.q_start
        if span < min_homozy_len:
            continue
        mm_rate = 100.0 * h.mismatches / max(span, 1)
        if mm_rate > max_homozy_subs:
            continue
        # only reduce the smaller of the pair (ties: later name)
        if (lens[h.chrom], h.chrom) <= (lens[h.query], h.query):
            continue
        spans[h.query].append((h.q_start, h.q_end))

    kept, reduced = [], 0
    for r in recs:
        cov = _covered(spans[r.name], len(r.codes), min_het_len)
        if cov / len(r.codes) >= min_reduce_cover:
            reduced += 1
        else:
            kept.append(r)
    stats = {"in": len(records), "kept": len(kept), "reduced": reduced,
             "short": len(records) - len(recs)}
    return kept, stats


def _covered(spans: list, length: int, min_het_len: int) -> int:
    """Union length of spans after closing gaps shorter than
    min_het_len (het regions flanked by homozygous treated as
    homozygous)."""
    if not spans:
        return 0
    spans = sorted(spans)
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s - merged[-1][1] < min_het_len:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged)


def write_reduced(path, kept: list) -> None:
    from ..io.fasta import write_fasta
    write_fasta(path, kept)
