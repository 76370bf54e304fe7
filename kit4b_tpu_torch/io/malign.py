"""Indexed multi-alignment store (the `.algn` bundle that `genmafalgn`
writes), the port's copy of kit4b_tpu/io/malign.py (host only;
tests/test_torch_rehomed.py holds it equal to the original statement for
statement): MAF blocks as code matrices in a compressed .npz, the
reference row fixing each block's coordinates (chrom, start, strand),
every species row a code vector with BASE_INDEL for gap columns, and each
row's own chrom, start and strand for ref -> rel projection.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna
from .maf import read_maf

MAGIC = "kit4b_tpu.algn.v1"


@dataclass
class AlignBlock:
    ref_chrom: str
    ref_start: int
    species: list          # row order
    rows: np.ndarray       # [n_species, cols] uint8 codes (INDEL for '-')
    score: float = 0.0
    # per-row coordinates from the source MAF (row order matches
    # `species`); empty for legacy bundles — MAlignFile.cpp keeps these
    # per-species loci for ref->rel projection (ref2relloci)
    starts: list = field(default_factory=list)     # per-row start
    chroms: list = field(default_factory=list)     # per-row chrom
    strands: list = field(default_factory=list)    # per-row strand

    def row_start(self, i: int) -> int:
        return self.starts[i] if self.starts else (
            self.ref_start if i == 0 else 0)

    def row_chrom(self, i: int) -> str:
        return self.chroms[i] if self.chroms else self.ref_chrom


@dataclass
class MAlign:
    species: list = field(default_factory=list)   # global species order
    blocks: list = field(default_factory=list)

    @classmethod
    def from_maf(cls, path, ref_species: str | None = None) -> "MAlign":
        """Build from MAF; the first `s` row of each block (or the row whose
        src prefixes ref_species) is the reference row."""
        ma = cls()
        seen = {}
        for blk in read_maf(path):
            if len(blk.seqs) < 2:
                continue
            ref_i = 0
            if ref_species:
                for i, s in enumerate(blk.seqs):
                    if s.src.split(".")[0] == ref_species:
                        ref_i = i
                        break
            ref = blk.seqs[ref_i]
            sp, rows, starts, chroms, strands = [], [], [], [], []
            order = [ref_i] + [i for i in range(len(blk.seqs))
                               if i != ref_i]
            for i in order:
                s = blk.seqs[i]
                name = s.src.split(".")[0]
                sp.append(name)
                rows.append(s.codes)
                starts.append(s.start)
                chroms.append(s.src.split(".", 1)[1] if "." in s.src
                              else s.src)
                strands.append(s.strand)
                if name not in seen:
                    seen[name] = len(seen)
            ma.blocks.append(AlignBlock(
                ref.src.split(".", 1)[1] if "." in ref.src else ref.src,
                ref.start, sp, np.stack(rows), blk.score,
                starts, chroms, strands))
        ma.species = sorted(seen, key=seen.get)
        return ma

    def save(self, path) -> None:
        arrs = {"__magic__": np.array(MAGIC),
                "__species__": np.array(self.species),
                "__n__": np.array(len(self.blocks))}
        meta = []
        rowmeta = []
        for i, b in enumerate(self.blocks):
            arrs[f"rows_{i}"] = b.rows
            meta.append(f"{b.ref_chrom}\t{b.ref_start}\t{b.score}\t"
                        + "\t".join(b.species))
            rowmeta.append("\t".join(
                f"{b.row_chrom(j)}|{b.row_start(j)}|"
                f"{b.strands[j] if b.strands else '+'}"
                for j in range(len(b.species))))
        arrs["__meta__"] = np.array(meta)
        arrs["__rowmeta__"] = np.array(rowmeta)
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path) -> "MAlign":
        z = np.load(path, allow_pickle=False)
        if str(z["__magic__"]) != MAGIC:
            raise ValueError(f"not a {MAGIC} file: {path}")
        ma = cls(species=[str(s) for s in z["__species__"]])
        rowmeta = z["__rowmeta__"] if "__rowmeta__" in z.files else None
        for i, m in enumerate(z["__meta__"]):
            chrom, start, score, *sp = str(m).split("\t")
            starts, chroms, strands = [], [], []
            if rowmeta is not None:
                for tok in str(rowmeta[i]).split("\t"):
                    c, s, st = tok.rsplit("|", 2)
                    chroms.append(c)
                    starts.append(int(s))
                    strands.append(st)
            ma.blocks.append(AlignBlock(chrom, int(start), sp,
                                        z[f"rows_{i}"], float(score),
                                        starts, chroms, strands))
        return ma
