"""SAM flag bits, the per-record writer and the SEQ/QUAL helper the port's
SAM writers use (copies of kit4b_tpu/io/sam.py's flags, `SamAlignment`,
`SamWriter` and `seq_qual_for_strand`; the header keeps the program name
kit4b_tpu, so both packages write the same bytes)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80


@dataclass
class SamAlignment:
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based leftmost
    mapq: int
    cigar: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: tuple = ()

    def line(self) -> str:
        fields = [self.qname, str(self.flag), self.rname, str(self.pos),
                  str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                  str(self.tlen), self.seq, self.qual]
        fields.extend(self.tags)
        return "\t".join(fields)


class SamWriter:
    """Text SAM: the @HD, @SQ and @PG header, then one line a record."""

    def __init__(self, path, chrom_names, chrom_lengths,
                 pg_name: str = "kit4b_tpu", pg_cl: str = ""):
        self._f = open(path, "w")
        self._f.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in zip(chrom_names, chrom_lengths):
            self._f.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
        self._f.write(f"@PG\tID:{pg_name}\tPN:{pg_name}\tCL:{pg_cl}\n")

    def write(self, aln: SamAlignment) -> None:
        self._f.write(aln.line() + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def seq_qual_for_strand(codes: np.ndarray, qual: np.ndarray | None,
                        reverse: bool) -> tuple[str, str]:
    """SEQ/QUAL strings; '-' strand hits emit the reverse complement
    (KAligner.cpp:6134-6145)."""
    if reverse:
        codes = dna.revcomp(codes)
        if qual is not None:
            qual = qual[::-1]
    seq = dna.decode(codes)
    q = "*" if qual is None else (np.asarray(qual, np.uint8) + 33
                                  ).tobytes().decode("ascii")
    return seq, q
