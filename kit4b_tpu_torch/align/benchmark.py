"""Alignment accuracy scorer (`benchmark -m 4`), the port's copy of
kit4b_tpu/align/benchmark.py (host code).

Mirrors CBenchmarker's ground-truth scoring mode (ngskit4b/Benchmarker.cpp;
tsBMGroundTruth Benchmarker.h:62-81; scoring weights
Docs/ngskit4b.benchmark.txt:15-25): reads carry their true origin in the
simreads descriptor (lcl|id|chrom|start|end|len|strand|subs|indel); any
aligner's SAM is scored read-by-read and base-by-base against it.

Base-level accounting for substitutions-only alignments: an aligned read
placed at the true locus scores its full length as matching; a misplaced read
scores its length as misaligned; an unaligned read as unaligned. Scores use
the reference's default weights (match +1, misaligned -2, unaligned -1 per
base — configurable).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..io.sam import read_sam
from ..sim.simreads import parse_truth


@dataclass
class ScoreWeights:
    match: float = 1.0
    misaligned: float = -2.0
    unaligned: float = -1.0


@dataclass
class BenchmarkResult:
    n_reads: int = 0
    n_aligned: int = 0
    n_correct: int = 0          # chrom+loci+strand correct
    n_loci_only: int = 0        # right loci, wrong strand
    n_misaligned: int = 0
    n_unaligned: int = 0
    n_no_truth: int = 0
    bases_match: int = 0
    bases_misaligned: int = 0
    bases_unaligned: int = 0
    score: float = 0.0

    def summary(self) -> dict:
        pa = self.n_aligned / max(1, self.n_reads)
        pc = self.n_correct / max(1, self.n_aligned)
        return {
            "reads": self.n_reads, "aligned": self.n_aligned,
            "correct": self.n_correct, "misaligned": self.n_misaligned,
            "unaligned": self.n_unaligned,
            "pct_aligned": round(100 * pa, 3),
            "pct_correct_of_aligned": round(100 * pc, 3),
            "base_score": round(self.score, 1),
            "bases_match": self.bases_match,
            "bases_misaligned": self.bases_misaligned,
            "bases_unaligned": self.bases_unaligned,
        }


def score_sam(sam_path, *, tolerance: int = 0,
              weights: ScoreWeights | None = None) -> BenchmarkResult:
    """Score a SAM produced from simreads ground-truth reads.

    tolerance: accepted positional slack in bp (the reference scores
    base-level overlap; exact by default).
    """
    w = weights or ScoreWeights()
    r = BenchmarkResult()
    seen: set[str] = set()
    for rec in read_sam(sam_path):
        if rec.flag & 0x100 or rec.flag & 0x800:
            continue  # secondary/supplementary
        truth = parse_truth(rec.qname)
        key = rec.qname + (":1" if rec.flag & 0x40 else
                           ":2" if rec.flag & 0x80 else "")
        if key in seen:
            continue
        seen.add(key)
        r.n_reads += 1
        if truth is None:
            r.n_no_truth += 1
            continue
        L = truth["len"]
        if not rec.is_mapped:
            r.n_unaligned += 1
            r.bases_unaligned += L
            r.score += w.unaligned * L
            continue
        r.n_aligned += 1
        pos_ok = (rec.rname == truth["chrom"]
                  and abs((rec.pos - 1) - truth["start"]) <= tolerance)
        strand_ok = (("-" if rec.is_reverse else "+") == truth["strand"])
        if pos_ok and strand_ok:
            r.n_correct += 1
            r.bases_match += L
            r.score += w.match * L
        elif pos_ok:
            r.n_loci_only += 1
            r.n_misaligned += 1
            r.bases_misaligned += L
            r.score += w.misaligned * L
        else:
            r.n_misaligned += 1
            r.bases_misaligned += L
            r.score += w.misaligned * L
    return r
