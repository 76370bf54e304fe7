"""Frozen input recipes: the genomes and readsets every cell is made from.

Everything here is made from the run's seed with numpy's default generator,
so one seed gives the same inputs in every run. The recipes are copies,
kept apart from the program so that a change to the program cannot change
what the benchmark feeds it:

- `random_genome`: one seeded random chromosome (the E. coli K-12 stand-in
  of `chip_smoke.py` phase 8b, at NC_000913.3's length).
- `r64_genome`: seeded random chromosomes of the given lengths with planted
  near-copies and N runs (the S. cerevisiae R64 stand-in of `chip_smoke.py`
  phase 4: forward copies of chromosome I segments and reverse-complement
  copies of chromosome XVI tail segments, 3 kbp with 4 substitutions each,
  and six N runs of 50-400 bp).
- `genome` picks one of the two by the configuration's `recipe`.
- `illumina_se_reads`: single-end reads with simreads' Illumina substitution
  model (`kit4b_tpu_torch/sim/simreads.py`: the per-read substitution count
  from the dynamic profile, P(0) = (1 - p)^L and then successive halving of
  the remainder; distinct positions from the 20-bin 3'-skewed spatial
  table; each substituted base replaced by one of the other three), named
  with simreads' ground-truth descriptor.

A genome is returned as (names, chromosome code arrays); `concat` lays
them out as the program's `Genome` does (an EOS code after each chromosome,
the last one EOG).
"""
from __future__ import annotations

import numpy as np

BASE_N, BASE_EOS, BASE_EOG = 4, 7, 0x0F
ACGTN = np.frombuffer(b"ACGTN", np.uint8)

# simreads' IlluminaSpatialDist: cumulative 20-bin position weights
ILLUMINA_SPATIAL = np.array([40, 55, 64, 72, 80, 88, 96, 104, 112, 121, 131,
                             142, 156, 174, 197, 228, 270, 325, 400, 500],
                            dtype=np.int64)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of base codes; N and sentinels keep their code."""
    rev = codes[..., ::-1]
    return np.where(rev < 4, 3 - rev, rev).astype(np.uint8)


def concat(chroms: list[np.ndarray]) -> np.ndarray:
    """The chromosomes end to end, each followed by EOS, the last by EOG."""
    parts = []
    for c in chroms:
        parts += [np.asarray(c, np.uint8), np.array([BASE_EOS], np.uint8)]
    seq = np.concatenate(parts)
    seq[-1] = BASE_EOG
    return seq


def random_genome(seed: int, genome: dict):
    """{"name", "length"} -> ([name], [codes]): uniform random ACGT."""
    rng = np.random.default_rng([seed, 1])
    codes = rng.integers(0, 4, int(genome["length"]), dtype=np.uint8)
    return [genome["name"]], [codes]


def r64_genome(seed: int, genome: dict):
    """{"names", "lengths", "copies", "copy_len", "copy_subs", "n_runs",
    "source_window"} -> (names, codes, planted [(chrom, start, len)]).
    Even copies are forward copies of a chromosome-I segment, odd ones
    reverse complements of a segment of the last chromosome's tail, each
    with `copy_subs` substitutions, placed in a chromosome other than the
    first and the last; then the N runs."""
    rng = np.random.default_rng([seed, 2])
    lengths = [int(n) for n in genome["lengths"]]
    chroms = [rng.integers(0, 4, n, dtype=np.uint8) for n in lengths]
    L, win = int(genome["copy_len"]), int(genome["source_window"])
    planted = []
    for i in range(int(genome["copies"])):
        if i % 2 == 0:
            s = int(rng.integers(1000, win))
            seg = chroms[0][s:s + L].copy()
        else:
            n_last = len(chroms[-1])
            s = int(rng.integers(n_last - win, n_last - L - 1000))
            seg = revcomp(chroms[-1][s:s + L])
        subs = rng.choice(L, int(genome["copy_subs"]), replace=False)
        seg[subs] = (seg[subs] + rng.integers(1, 4, len(subs))) % 4
        c = int(rng.integers(1, len(chroms) - 1))
        d = int(rng.integers(0, len(chroms[c]) - L))
        chroms[c][d:d + L] = seg
        planted.append((c, d, L))
    for _ in range(int(genome["n_runs"])):
        c = int(rng.integers(0, len(chroms)))
        d = int(rng.integers(0, len(chroms[c]) - 400))
        chroms[c][d:d + int(rng.integers(50, 400))] = BASE_N
    return list(genome["names"]), chroms, planted


def genome(seed: int, cfg: dict):
    """The configuration's genome by its `recipe`: (names, chromosome
    codes, planted copies [(chrom, start, len)])."""
    if cfg["recipe"] == "random":
        return (*random_genome(seed, cfg), [])
    if cfg["recipe"] == "r64":
        return r64_genome(seed, cfg)
    raise ValueError(f"unknown genome recipe {cfg['recipe']!r}")


def subs_count_probs(rate: float, L: int) -> np.ndarray:
    """simreads' dynamic profile over 0..8 substitutions a read."""
    p = np.zeros(9)
    cur, acc = (1.0 - rate) ** L, 0.0
    for i in range(8):
        p[i] = cur
        acc += cur
        cur = (1.0 - acc) / 2.0
    p[8] = max(0.0, 1.0 - p[:8].sum())
    return p / p.sum()


def _spatial_positions(m: int, L: int, rng) -> np.ndarray:
    nb = len(ILLUMINA_SPATIAL)
    u = rng.integers(0, ILLUMINA_SPATIAL[-1] + 1, m)
    d = np.minimum(np.searchsorted(ILLUMINA_SPATIAL, u, side="left"), nb - 1)
    lo = (d * L) // nb
    hi = np.maximum(np.where(d == nb - 1, L - 1, lo + L // nb - 1), lo)
    return rng.integers(lo, hi + 1)


def illumina_se_reads(seed: int, chrom: str, codes: np.ndarray, reads: dict):
    """{"n_reads", "read_len", "subs_rate"} -> (names uint8 [n, w] ASCII,
    reads uint8 [n, L], truth dict of int64 arrays start, strand, subs).
    Reads come from both strands of the one chromosome `codes`."""
    rng = np.random.default_rng([seed, 3])
    n, L = int(reads["n_reads"]), int(reads["read_len"])
    start = rng.integers(0, len(codes) - L + 1, n)
    strand = rng.integers(0, 2, n)
    r = np.lib.stride_tricks.sliding_window_view(codes, L)[start]
    rev = strand == 1
    r[rev] = revcomp(r[rev])
    counts = rng.choice(9, size=n, p=subs_count_probs(
        float(reads["subs_rate"]), L))
    pos = np.full((n, 8), -1, np.int64)
    for j in range(int(counts.max())):
        need = np.nonzero(counts > j)[0]
        while len(need):      # distinct positions: redraw on collision
            p = _spatial_positions(len(need), L, rng)
            fresh = ~(pos[need, :j] == p[:, None]).any(1)
            pos[need[fresh], j] = p[fresh]
            need = need[~fresh]
    ri, ji = np.nonzero(np.arange(8) < counts[:, None])
    pi = pos[ri, ji]
    r[ri, pi] = (r[ri, pi] + rng.integers(1, 4, len(ri), dtype=np.uint8)) % 4
    names = read_names(chrom, len(str(len(codes))), start, L, strand,
                       counts)
    return names, r, {"start": start, "strand": strand,
                      "subs": counts.astype(np.int64)}


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII digits of x, zero-padded."""
    x = x.astype(np.int64)
    out = np.empty((len(x), width), np.uint8)
    for i in range(width - 1, -1, -1):
        x, d = np.divmod(x, 10)
        out[:, i] = 48 + d
    return out


def read_names(chrom: str, w: int, start, L: int, strand,
               subs) -> np.ndarray:
    """simreads' truth descriptor `lcl|id|chrom|start|end|len|strand|subs|0`
    with the ids zero-padded to 8 digits and the loci to `w`, as a [n,
    width] uint8 array of ASCII (ids from 1)."""
    n = len(start)
    bar = np.full((n, 1), ord("|"), np.uint8)
    const = lambda b: np.broadcast_to(np.frombuffer(b, np.uint8),
                                      (n, len(b)))
    return np.ascontiguousarray(np.concatenate([
        const(b"lcl|"), _digits(np.arange(1, n + 1), 8), bar,
        const(chrom.encode() + b"|"), _digits(start, w), bar,
        _digits(start + L - 1, w), bar, const(f"{L}|".encode()),
        np.where(strand[:, None] == 0, ord("+"), ord("-")).astype(np.uint8),
        bar, _digits(subs, 1), const(b"|0")], axis=1))


def write_reads_fasta(path, names: np.ndarray, codes: np.ndarray) -> None:
    """Single-line FASTA of fixed-width names [n, w] and reads [n, L]."""
    n = len(codes)
    rec = np.concatenate([
        np.full((n, 1), ord(">"), np.uint8), names,
        np.full((n, 1), 10, np.uint8), ACGTN[np.minimum(codes, 4)],
        np.full((n, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())
