"""The PacBio CLR readset of tools/pacbio_scale.py, the port's copy.

`simulate(kbp, cov)` draws what that tool's `main` draws from
`default_rng(99)`: a random genome of `kbp` kbp, then reads of 10-18 kbp
spans at random starts, each corrupted by `corrupt_pacbio` (the CLR
profile: 10 % insertions, 4 % deletions, 0.5 % substitutions), until the
spans reach `cov` times the genome. At the tool's realistic size (100 kbp
at 8x) that is 59 reads of about 10.6-18.7 kbp. Each read is named
`pb<i>|<start>|<span>`, its truth window in the genome.
`identity_vs_truth` is the tool's quality figure: the banded-SW score
density of a read against its truth window (host numpy around the port's
`banded_sw_batch` on `device`).
"""
from __future__ import annotations

import numpy as np

from ..io.fasta import SeqRecord
from ..pacbio.sswd import SWScores, banded_sw_batch

SEED = 99


def corrupt_pacbio(seq: np.ndarray, rng, ins=0.10, dele=0.04,
                   sub=0.005) -> np.ndarray:
    """CLR-profile corruption: insertion-dominant with rare
    substitutions (real CLR error is ~85% accuracy, mostly insertions)."""
    out = []
    for b in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append((int(b) + int(rng.integers(1, 4))) % 4)
        else:
            out.append(int(b))
        while rng.random() < ins:
            out.append(int(rng.integers(0, 4)))
    return np.asarray(out, np.uint8)


def simulate(kbp: float = 100.0, cov: float = 8.0, seed: int = SEED):
    """(genome codes, reads, [(start, span)] truth windows)."""
    n = int(kbp * 1000)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n).astype(np.uint8)
    reads, truth = [], []
    total = 0
    while total < n * cov:
        span = int(rng.integers(10_000, 18_000))
        start = int(rng.integers(0, n - span))
        raw = corrupt_pacbio(genome[start:start + span], rng)
        reads.append(SeqRecord(f"pb{len(reads)}|{start}|{span}", "", raw))
        truth.append((start, span))
        total += span
    return genome, reads, truth


def identity_vs_truth(read: np.ndarray, genome: np.ndarray, start: int,
                      span: int, band: int = 2048,
                      device="cuda") -> float:
    """Banded-SW identity of `read` against its truth window: the score
    over the aligned probe length (scores 1, -1, -2, -1)."""
    lo = max(0, start - 500)
    hi = min(len(genome), start + span + 500)
    tgt = genome[lo:hi]
    L = len(read)
    a = banded_sw_batch(
        read[None, :].astype(np.uint8), np.asarray([L], np.int32),
        tgt[None, :].astype(np.uint8), np.asarray([len(tgt)], np.int32),
        np.asarray([start - lo], np.int32), band=band,
        scores=SWScores(1, -1, -2, -1), device=device)[0]
    return max(0.0, a.score / max(1, a.p_end - a.p_start))
