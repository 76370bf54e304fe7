"""BASELINE config #5's readset: a bacterial-scale genome and paired ends.

The port's copy of the generator in tools/config5_bacterial.py, so a
machine without the JAX package builds the same reads from the same seeds:
a random genome from `default_rng(55)`, paired ends of 2 x 150 bp (inserts
250-500, Illumina-skewed 0.5 % substitutions, seed 5) at the requested
coverage, then 10 % of the pairs duplicated so the filter's dedup has work.
The assembler's parameters of that script are `ASSEMBLE_PARAMS`.

One change: the two mates of a pair share a name here (`p0000001`, ...;
the simulator's name, which gives each mate its own locus, moves to the
description). `scaffold` and `pescaffold` pair mates by name, so with the
simulator's names no pair links two contigs (ROADMAP.md queue C).
"""
from __future__ import annotations

import numpy as np

from ..io.fasta import Genome, SeqRecord
from ..sim import simreads

READ_LEN = 150
# tools/config5_bacterial.py's AssembleParams for the fused route
ASSEMBLE_PARAMS = dict(min_overlap=60, min_overlap_final=40)


def make_config5(kbp: float, cov: float):
    """(genome codes, mate-1 records, mate-2 records): the genome as one
    sequence "bact1", int(bases * cov / 300) simulated pairs, then a tenth
    of them again, each pair under one name."""
    n = int(kbp * 1000)
    rng = np.random.default_rng(55)
    seq = rng.integers(0, 4, n).astype(np.uint8)
    g = Genome.from_records([SeqRecord("bact1", "", seq)])
    pairs = int(n * cov / 300)
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=pairs, read_len=READ_LEN, pe=True, pe_insert_min=250,
        pe_insert_max=500, error_mode="illumina", subs_rate=0.005, seed=5))
    dup = rng.choice(pairs, pairs // 10)
    r1 = r1 + [r1[i] for i in dup]
    r2 = r2 + [r2[i] for i in dup]
    return seq, pair_named(r1), pair_named(r2)


def pair_named(records):
    """The records renamed by their pair's ordinal, the simulator's name
    kept as the description."""
    return [SeqRecord(f"p{j + 1:07d}", r.name, r.codes, r.qual)
            for j, r in enumerate(records)]
