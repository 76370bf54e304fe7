"""PBA (Packed Base Alleles): per-locus allele scores in one byte. The
port's copy of kit4b_tpu/kmer/pba.py's `pba_from_counts`, `save_pba` and
`load_pba`, the parts `kalign -3` and `genpba` write and the tests read.

Capability parity with genpba (ngskit4b/KAlignerCL.cpp:1491 kalignerPBA):
each locus packs four 2-bit allele scores, A in bits 7.6, C in 5.4, G in
3.2, T in 1.0 (CallHaplotypes.h:31), scored from allele proportions with
the reference's coverage-dependent thresholds (CallHaplotypes.h:33-39):

  coverage >= 5:  3 if prop >= 0.75, 2 if >= 0.35, 1 if >= 0.20
  coverage <  5:  2 if prop >= 0.70, 1 if >= 0.30

Container: .pba.npz holding per-chromosome byte arrays + names.
"""
from __future__ import annotations

import numpy as np

SCORE3_MIN = 0.75
SCORE2_MIN = 0.35
SCORE1_MIN = 0.20
SCORE2_LC = 0.70
SCORE1_LC = 0.30
MIN_COV = 5


def pba_from_counts(counts: np.ndarray) -> np.ndarray:
    """counts [G, >=4] (A,C,G,T[,N]) -> PBA bytes [G] (vectorized)."""
    acgt = counts[:, :4].astype(np.float64)
    cov = acgt.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        prop = np.where(cov[:, None] > 0, acgt / np.maximum(cov[:, None], 1),
                        0.0)
    hi = cov[:, None] >= MIN_COV
    score = np.zeros(acgt.shape, np.uint8)
    score = np.where(hi & (prop >= SCORE1_MIN), 1, score)
    score = np.where(hi & (prop >= SCORE2_MIN), 2, score)
    score = np.where(hi & (prop >= SCORE3_MIN), 3, score)
    score = np.where(~hi & (prop >= SCORE1_LC), 1, score)
    score = np.where(~hi & (prop >= SCORE2_LC), 2, score)
    score = np.where(cov[:, None] == 0, 0, score)
    # pack: A<<6 | C<<4 | G<<2 | T
    return ((score[:, 0].astype(np.uint8) << 6)
            | (score[:, 1] << 4) | (score[:, 2] << 2)
            | score[:, 3]).astype(np.uint8)


def save_pba(path, genome, pba_concat: np.ndarray,
             readset: str = "readset") -> None:
    """Split concatenated-genome PBA bytes into per-chrom arrays and save."""
    arrays = {}
    for i, name in enumerate(genome.names):
        s = int(genome.starts[i])
        arrays[f"chrom:{name}"] = pba_concat[s: s + int(genome.lengths[i])]
    np.savez_compressed(path, readset=np.array(readset),
                        names=np.array(genome.names, dtype=object),
                        **arrays)


def load_pba(path) -> tuple[str, dict]:
    z = np.load(path, allow_pickle=True)
    names = list(z["names"])
    return str(z["readset"]), {n: z[f"chrom:{n}"] for n in names}
