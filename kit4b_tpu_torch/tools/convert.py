"""Element loci CSV reading, the part of kit4b_tpu/tools/convert.py that
`rnade -x` needs (`read_loci_csv`), copied as it is.

Loci CSV rows follow the reference's 8-field element convention
(csv2fasta.cpp:685-701): SrcID, ElType, Species, Chrom, StartLoci,
EndLoci, Len, Strand.
"""
from __future__ import annotations

import csv


def read_loci_csv(path) -> list[dict]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 7:
                continue
            try:
                srcid = int(row[0].strip('"'))
            except ValueError:
                continue   # header
            out.append({
                "srcid": srcid, "type": row[1].strip().strip('"'),
                "species": row[2].strip().strip('"'),
                "chrom": row[3].strip().strip('"'),
                "start": int(row[4]), "end": int(row[5]),
                "len": int(row[6]),
                "strand": row[7].strip().strip('"')
                if len(row) > 7 else "+"})
    return out
