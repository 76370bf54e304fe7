"""SAM flag bits, the per-record writer, the SEQ/QUAL helper and the text
reader the port's SAM writers and the DiSNP pass use (copies of
kit4b_tpu/io/sam.py's flags, `SamAlignment`, `SamWriter`, `SamRecord`,
`read_sam` and `seq_qual_for_strand`; the header keeps the program name
kit4b_tpu, so both packages write the same bytes)."""
from __future__ import annotations

from dataclasses import dataclass, field

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


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    rnext: str
    pnext: int
    tlen: int
    seq: str
    qual: str
    opt: dict = field(default_factory=dict)   # optional TAG:TYPE:VALUE fields

    def tag(self, name: str, default=None):
        """Typed optional-field value (NM, AS, ... — SAMfile.cpp opt
        field parsing); int/float types are converted."""
        return self.opt.get(name, default)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)


def read_sam(path):
    """Minimal SAM text reader (CSAMfile read parity, libkit4b/SAMfile.cpp)."""
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            opt = {}
            for tok in fields[11:]:
                parts = tok.split(":", 2)
                if len(parts) != 3:
                    continue
                tagname, typ, val = parts
                if typ == "i":
                    opt[tagname] = int(val)
                elif typ == "f":
                    opt[tagname] = float(val)
                else:
                    opt[tagname] = val
            yield SamRecord(fields[0], int(fields[1]), fields[2],
                            int(fields[3]), int(fields[4]), fields[5],
                            fields[6], int(fields[7]), int(fields[8]),
                            fields[9], fields[10], opt)


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
