"""simreads: simulated single-end readset with embedded ground truth, the
port's own copy of the single-end, substitution-only part of
kit4b_tpu/sim/simreads.py (paired ends, InDels, adapter artefacts, random
reads, region restriction and dedupe stay in the JAX package until the port
has a path that uses them).

Each read is named with the ground-truth descriptor of the reference
CSimReads (libkit4b/SimReads.cpp:1655), so the `benchmark` scorer and the
reference's own can read either output:

    >lcl|NNNNNNNN|chrom|start|end|len|strand|numsubs|indelsize

(`end` = start + len - 1; indelsize is always 0 here.)

Per read: a placement proportional to chromosome length, a strand (both
strands equally), the strand revcomp, then sequencer substitutions.

Error models:
  - 'illumina': the reference's dynamic composite profile. Per-read
    substitution COUNTS from P(0) = (1-p)^L, then successive halving of the
    remainder (SimReads.cpp:295-312); POSITIONS from the 20-bin
    IlluminaSpatialDist cumulative table (:268, moderate 5' rise, heavy 3'
    tail).
  - 'uniform': flat per-base Bernoulli (an exact mean rate).
  - 'none': reads copied from the genome.

Vectorized NumPy with a seeded Generator instead of per-thread CTwister
streams; the same parameters draw the same stream as the JAX package's
copy, so both give the same reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io.fasta import Genome, SeqRecord, write_fasta, write_fastq

# IlluminaSpatialDist (SimReads.cpp:268): cumulative 20-bin position
# weights over the read length; moderate 5' rise, most errors at 3'
_ILLUMINA_SPATIAL = np.array([40, 55, 64, 72, 80, 88, 96, 104, 112, 121,
                              131, 142, 156, 174, 197, 228, 270, 325,
                              400, 500], dtype=np.int64)


@dataclass
class SimParams:
    n_reads: int = 100_000
    read_len: int = 100
    # error model: 'none' | 'uniform' | 'illumina'
    error_mode: str = "none"
    subs_rate: float = 0.01      # mean per-base substitution rate
    seed: int = 1


def _count_probs(subs_rate: float, L: int) -> np.ndarray:
    """Per-read substitution-count distribution over 0..8 subs
    (SimReads.cpp:295-312): P(0)=(1-p)^L, then halve the remainder."""
    p = np.zeros(8)
    cur = (1.0 - subs_rate) ** L
    acc = 0.0
    for i in range(8):
        p[i] = cur
        acc += cur
        cur = (1.0 - acc) / 2.0
    probs = np.zeros(9)
    probs[:8] = p
    probs[8] = max(0.0, 1.0 - p.sum())
    return probs / probs.sum()


def _spatial_positions(m: int, L: int, rng: np.random.Generator):
    """Illumina 3'-skewed positions: bin by the cumulative spatial table,
    then uniform within the bin's read-length twentieth."""
    nb = len(_ILLUMINA_SPATIAL)
    u = rng.integers(0, _ILLUMINA_SPATIAL[-1] + 1, m)
    d = np.searchsorted(_ILLUMINA_SPATIAL, u, side="left")
    d = np.minimum(d, nb - 1)
    minp = (d * L) // nb
    maxp = np.where(d == nb - 1, L - 1, minp + L // nb - 1)
    maxp = np.maximum(maxp, minp)
    return rng.integers(minp, maxp + 1)


def _apply_errors(reads: np.ndarray, params: SimParams,
                  rng: np.random.Generator) -> np.ndarray:
    """Substitute bases in-place; returns per-read substitution counts."""
    n, L = reads.shape
    mode = params.error_mode
    if mode == "none" or n == 0:
        return np.zeros(n, dtype=np.int32)
    if mode == "uniform":
        hit = rng.random((n, L)) < params.subs_rate
        hit &= reads < 4
        delta = rng.integers(1, 4, size=(n, L), dtype=np.uint8)
        reads[hit] = (reads[hit] + delta[hit]) % 4
        return hit.sum(axis=1).astype(np.int32)
    if mode != "illumina":
        raise ValueError(f"unknown error mode {mode}")
    counts = rng.choice(9, size=n, p=_count_probs(params.subs_rate, L))
    counts = counts.astype(np.int32)
    # draw `counts[i]` DISTINCT positions per read (reference redraws on
    # collision, SimReads.cpp:352-358), spatially skewed
    used = np.zeros((n, L), bool)
    for j in range(int(counts.max())):
        need = np.nonzero(counts > j)[0]
        while len(need):
            p = _spatial_positions(len(need), L, rng)
            fresh = ~used[need, p]
            used[need[fresh], p[fresh]] = True
            need = need[~fresh]
    # count only positions actually substituted: a drawn position that
    # landed on an N base gets no edit, so it must not inflate numsubs
    applied = used & (reads < 4)
    ridx, pidx = np.nonzero(applied)
    delta = rng.integers(1, 4, len(ridx), dtype=np.uint8)
    reads[ridx, pidx] = (reads[ridx, pidx] + delta) % 4
    return applied.sum(axis=1).astype(np.int32)


def sim_reads(genome: Genome, params: SimParams,
              start_id: int = 1) -> list[SeqRecord]:
    """Generate `params.n_reads` single-end reads (fewer when a chromosome
    drawn is shorter than a read)."""
    rng = np.random.default_rng(params.seed)
    L = params.read_len
    ci = rng.choice(len(genome.names), size=params.n_reads,
                    p=genome.lengths / genome.lengths.sum())
    max_start = genome.lengths[ci] - L
    ci, max_start = ci[max_start >= 0], max_start[max_start >= 0]
    n = len(ci)
    start = (rng.random(n) * (max_start + 1)).astype(np.int64)
    rev = rng.integers(0, 2, n).astype(np.int8) == 1
    idx = (genome.starts[ci] + start)[:, None] + np.arange(L)[None, :]
    reads = genome.seq[np.minimum(idx, len(genome.seq) - 1)]
    reads[rev] = dna._COMPLEMENT[reads[rev]][:, ::-1]
    subs = _apply_errors(reads, params, rng)
    return [SeqRecord(f"lcl|{start_id + i:08d}|{genome.names[ci[i]]}|"
                      f"{int(start[i])}|{int(start[i]) + L - 1}|{L}|"
                      f"{'-' if rev[i] else '+'}|{int(subs[i])}|0",
                      "", reads[i])
            for i in range(n)]


def parse_truth(qname: str):
    """Parse a simreads ground-truth read name -> dict (or None)."""
    parts = qname.split("|")
    if len(parts) != 9 or parts[0] not in ("lcl", "lcr"):
        return None
    return {
        "random": parts[0] == "lcr",
        "read_id": int(parts[1]),
        "chrom": parts[2],
        "start": int(parts[3]),
        "end": int(parts[4]),
        "len": int(parts[5]),
        "strand": parts[6],
        "subs": int(parts[7]),
        "indel": int(parts[8]),
    }


def write_reads(path, records, fmt: str = "fasta") -> None:
    if fmt == "fasta":
        write_fasta(path, records)
    else:
        write_fastq(path, records)
