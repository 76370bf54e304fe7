"""Gene models from BED, the part of kit4b_tpu/io/biobed.py that `rnade`
needs (`GeneModel`, `load_gene_bed`), copied as it is.

Gene models come from BED12 (thickStart/thickEnd = CDS span, blocks =
exons) or plain BED6 (whole feature treated as a single CDS exon), the
same degradation the reference applies to non-biobed BED files
(libkit4b/BEDfile.h).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class GeneModel:
    chrom: str
    start: int            # transcript start (0-based)
    end: int              # exclusive
    name: str
    strand: str
    cds_start: int        # thickStart
    cds_end: int          # thickEnd (== cds_start for non-coding)
    exon_starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    exon_ends: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


def load_gene_bed(path) -> list[GeneModel]:
    genes = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if (not line or line[0] == "#" or line.startswith("track")
                    or line.startswith("browser")):
                continue
            c = line.split("\t")
            if len(c) < 3:
                c = line.split()
            start, end = int(c[1]), int(c[2])
            name = c[3] if len(c) > 3 else f"{c[0]}:{start}"
            strand = c[5] if len(c) > 5 else "+"
            if len(c) >= 12:
                cds_s, cds_e = int(c[6]), int(c[7])
                sizes = np.asarray(
                    [int(x) for x in c[10].rstrip(",").split(",")], np.int64)
                offs = np.asarray(
                    [int(x) for x in c[11].rstrip(",").split(",")], np.int64)
                ex_s = start + offs
                ex_e = ex_s + sizes
            else:
                cds_s, cds_e = start, end
                ex_s = np.asarray([start], np.int64)
                ex_e = np.asarray([end], np.int64)
            genes.append(GeneModel(c[0], start, end, name, strand,
                                   cds_s, cds_e, ex_s, ex_e))
    return genes
