"""BASELINE config #4's genome: a human-chr21-like synthetic chromosome.

The port's copy of `make_chr21_like` from tools/config4_chr21.py, so a
machine without the JAX package builds the same bases from the same seed:
a random backbone, an Alu-like 300 bp family at about 20 % of the genome
with 10 % divergence, a 171 bp alpha-satellite-like tandem array at the
centre, and N runs over both telomeres and beside the centromere.
"""
from __future__ import annotations

import numpy as np

from .. import dna


def make_chr21_like(mbp: float, seed: int = 21):
    """Repeat-dense synthetic chromosome (chr21 proxy): (codes with a
    trailing EOG, length without it)."""
    n = int(mbp * 1e6)
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, n).astype(np.uint8)
    # Alu-like family: 300bp consensus, ~20% of the genome, 10% divergence
    alu = rng.integers(0, 4, 300).astype(np.uint8)
    n_copies = int(n * 0.20 / 300)
    pos = rng.integers(0, n - 400, n_copies)
    for p in pos:
        copy = alu.copy()
        nmut = rng.binomial(300, 0.10)
        at = rng.integers(0, 300, nmut)
        copy[at] = (copy[at] + rng.integers(1, 4, nmut)) % 4
        seq[p:p + 300] = copy
    # tandem satellite near the "centromere"
    unit = rng.integers(0, 4, 171).astype(np.uint8)  # alpha-satellite-like
    c0 = n // 2
    for i in range(2000):
        p = c0 + i * 171
        if p + 171 > n:
            break
        seq[p:p + 171] = unit
    # N runs: telomeres + centromere gap
    seq[: n // 200] = dna.BASE_N
    seq[-n // 200:] = dna.BASE_N
    seq[c0 - 50_000: c0 - 20_000] = dna.BASE_N
    return np.concatenate([seq, [dna.BASE_EOG]]).astype(np.uint8), n

