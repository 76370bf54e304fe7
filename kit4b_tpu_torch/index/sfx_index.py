"""Genome index: suffix array + k-mer bucket LUT, the port's own copy of
kit4b_tpu/index/sfx_index.py (tests/test_torch_rehomed.py holds its arrays
equal to the original's).

Capability parity with the reference CSfxArray (libkit4b/SfxArray.h:97-209,
SfxArray.cpp:1758 Finalise / :3309 IterateExacts / :7938 LocateFirstExact):

- The genome is one concatenated uint8 code array with EOS sentinels between
  chromosomes (same scheme as the reference's concatenated SfxBlock).
- Only the "clean" suffixes (first `lut_k` bases all ACGT) are kept, in
  lexicographic order, with a direct-addressed bucket table over all 4^lut_k
  k-mer prefixes: a seed lookup is two gathers (bucket start + end).

File format: .kix (NumPy .npz) holding genome seq, chrom directory, clean SA
and LUT, the analog of the reference's .sfx V5 file (SfxArray.h:194-209).
The format is the JAX package's: an index that either package writes loads
in the other. Both builds run on the port's host library (`native.py`)
and raise `NativeUnavailable` without it: there is no numpy fallback. A
bisulfite index (align/bisulfite.py) builds its two collapsed-genome
indexes with LUT radix 3 and a monotone code-to-digit map (`lut_base`,
`digit_map`); the default radix 4 is plain DNA.
"""
from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from .. import dna, native
from ..io.fasta import Genome
from ..utils.runtime import span
from .sa_build import build_suffix_array

KIX_VERSION = 1


def pick_lut_k(genome_len: int) -> int:
    """LUT k-mer width: ~log4(G) like the reference's auto core length
    (ngskit4b/KAligner.cpp:9369-9374), clamped to [8, 13] to bound LUT memory
    at 4^13+1 int32 = 256 MiB worst case."""
    k = 1
    g = genome_len
    while g >= 4:
        g >>= 2
        k += 1
    return max(8, min(13, k))


@dataclass
class SfxIndex:
    genome: Genome
    lut_k: int
    sa_clean: np.ndarray  # int32/int64 [M] clean-suffix positions, lex order
    lut: np.ndarray       # int64 [4^lut_k + 1] bucket starts into sa_clean

    # LUT radix: 4 for plain DNA; 3 with a digit_map for bisulfite-collapsed
    # alphabets (align/bisulfite.py) so direct addressing stays dense
    lut_base: int = 4
    digit_map: tuple | None = None

    @classmethod
    def build(cls, genome: Genome, lut_k: int | None = None,
              lut_base: int = 4,
              digit_map: tuple | None = None) -> "SfxIndex":
        seq = genome.seq
        if lut_k is None:
            lut_k = pick_lut_k(len(seq))
        with span("sfx.sais"):
            sa = build_suffix_array(seq)
        # Clean mask: suffix has lut_k in-bounds bases all < BASE_N.
        n = len(seq)
        k = lut_k
        with span("sfx.mask"):
            ok = np.ones(n, dtype=bool)
            isbase = seq < dna.BASE_N
            # ok[p] = all(isbase[p:p+k]), by a cumulative sum of non-bases
            bad = (~isbase).astype(np.int64)
            cbad = np.concatenate([[0], np.cumsum(bad)])
            ok[: n - k + 1] = (cbad[k:] - cbad[:-k]) == 0
            if k > 1:
                ok[n - k + 1:] = False
            sa_clean = sa[ok[sa]]
        # Keys of clean suffixes (non-decreasing in SA order; any digit_map
        # must be monotone in code order so bucket ranges stay contiguous).
        dm = np.arange(4, dtype=np.int64) if digit_map is None \
            else np.asarray(digit_map, dtype=np.int64)
        with span("sfx.keys"):
            keys = np.zeros(len(sa_clean), dtype=np.int64)
            for j in range(k):
                keys = keys * lut_base + dm[seq[sa_clean + j]]
        with span("sfx.lut"):
            lut = np.searchsorted(
                keys, np.arange(lut_base**k + 1, dtype=np.int64)
            ).astype(np.int64)
        return cls(genome, k, sa_clean.astype(
            np.int32 if n < 2**31 else np.int64), lut,
            lut_base=lut_base, digit_map=digit_map)

    @classmethod
    def build_buckets(cls, genome: Genome,
                      lut_k: int | None = None) -> "SfxIndex":
        """k-mer BUCKET index: clean positions grouped by lut_k-mer key,
        ascending by position inside a bucket; no suffix sorting.

        The seed-and-extend passes only resolve key buckets and verify
        candidates by extension, so full lexicographic suffix order is
        refinement they never read; the native counting sort
        (`bucket_index`: one histogram and one scatter pass) replaces
        SA-IS at a fraction of the cost. Genomes of 2^31 bases or more and
        lut_k above 15 are outside its range and raise ValueError."""
        seq = genome.seq
        if lut_k is None:
            lut_k = pick_lut_k(len(seq))
        n = len(seq)
        k = lut_k
        if n < k:
            return cls(genome, k, np.zeros(0, np.int32),
                       np.zeros(4 ** k + 1, np.int64))
        if n >= 2 ** 31 or k > 15:
            raise ValueError(f"bucket index of {n} bases at lut_k {k}: "
                             "needs fewer than 2^31 bases and lut_k <= 15")
        lib = native.load()
        seq_c = np.ascontiguousarray(seq, dtype=np.uint8)
        sa_buf = np.empty(n - k + 1, np.int32)
        lut = np.empty(4 ** k + 1, np.int64)
        ngood = lib.bucket_index(
            seq_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, k,
            sa_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if ngood < 0:
            raise RuntimeError(f"native bucket_index failed with code {ngood}")
        return cls(genome, k, sa_buf[:ngood].copy(), lut)

    # --- persistence (.kix) -------------------------------------------------
    def save(self, path: str | os.PathLike) -> None:
        np.savez_compressed(
            path if str(path).endswith(".npz") else str(path),
            version=np.int64(KIX_VERSION),
            lut_k=np.int64(self.lut_k),
            seq=self.genome.seq,
            chrom_names=np.array(self.genome.names, dtype=object),
            chrom_starts=self.genome.starts,
            chrom_lengths=self.genome.lengths,
            sa_clean=self.sa_clean,
            lut=self.lut,
            allow_pickle=True)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "SfxIndex":
        path = str(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        if int(z["version"]) != KIX_VERSION:
            raise ValueError(f"unsupported .kix version {int(z['version'])}")
        g = Genome(list(z["chrom_names"]), z["chrom_starts"],
                   z["chrom_lengths"], z["seq"])
        return cls(g, int(z["lut_k"]), z["sa_clean"], z["lut"])
