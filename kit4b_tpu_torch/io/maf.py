"""MAF (Multiple Alignment Format) reader, the port's copy of
kit4b_tpu/io/maf.py.

Parses the block structure consumed by the reference's MAF workflows
(pacbiokit4b/MAFKMerDist.cpp MAF block parser; ngskit4b genmafalgn):
`a` lines open a block with attributes, `s` lines carry
(src, start, size, strand, srcSize, gapped-text)."""
from __future__ import annotations

from dataclasses import dataclass

import gzip
import numpy as np

from .. import dna


@dataclass
class MAFSeq:
    src: str
    start: int
    size: int
    strand: str
    src_size: int
    text: str          # alignment row incl. '-' gaps

    @property
    def codes(self) -> np.ndarray:
        """etSeqBase codes; '-' maps to BASE_INDEL."""
        return dna.encode(self.text)


@dataclass
class MAFBlock:
    score: float
    seqs: list


def read_maf(path):
    """Yield MAFBlock records (gz transparent)."""
    op = gzip.open if str(path).endswith(".gz") else open
    blk = None
    with op(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("a"):
                if blk and blk.seqs:
                    yield blk
                score = 0.0
                for kv in line.split()[1:]:
                    if kv.startswith("score="):
                        score = float(kv[6:])
                blk = MAFBlock(score, [])
            elif line.startswith("s") and blk is not None:
                p = line.split()
                blk.seqs.append(MAFSeq(p[1], int(p[2]), int(p[3]), p[4],
                                       int(p[5]), p[6]))
            elif not line.strip() and blk and blk.seqs:
                yield blk
                blk = None
    if blk and blk.seqs:
        yield blk
