"""Gene-model region classification (CBEDfile feature-bits parity), the
port's copy of kit4b_tpu/io/biobed.py (host only; tests/test_torch_rehomed.py
holds it equal to the original statement for statement).

Loci are classified against gene annotation into the reference's region
bits (libkit4b/BEDfile.h): CDS, 5'UTR, 3'UTR, intron, upstream,
downstream, 5' and 3' splice sites, intergenic as 0 in loci CSV region
fields. Gene models come from BED12 (thickStart/thickEnd the CDS span,
blocks the exons) or plain BED6 (the whole feature one CDS exon).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FEAT_CDS = 0x01
FEAT_5UTR = 0x02
FEAT_3UTR = 0x04
FEAT_INTRON = 0x08
FEAT_UPSTREAM = 0x10
FEAT_DNSTREAM = 0x20
FEAT_5SPLICE = 0x40
FEAT_3SPLICE = 0x80

# region ordinal -> bit, per the CLI convention "1: Intergenic, 2: US,
# 3: 5'UTR, 4: CDS, 5: Intron, 6: 3'UTR, 7: DS, 8: 5'Splice, 9: 3'Splice"
# (csvfilter.cpp RegionsIn/RegionsOut help text)
REGION_ORD_BITS = {
    1: 0,            # intergenic has no bit; region value 0
    2: FEAT_UPSTREAM,
    3: FEAT_5UTR,
    4: FEAT_CDS,
    5: FEAT_INTRON,
    6: FEAT_3UTR,
    7: FEAT_DNSTREAM,
    8: FEAT_5SPLICE,
    9: FEAT_3SPLICE,
}

SPLICE_OVERLAP = 4   # bases of intron flank treated as splice site


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


class RegionClassifier:
    """Classify loci into reference feature bits against gene models."""

    def __init__(self, genes: list[GeneModel], reg_len: int = 2000):
        self.reg_len = reg_len
        self.by_chrom: dict[str, list[GeneModel]] = {}
        for g in genes:
            self.by_chrom.setdefault(g.chrom, []).append(g)
        for lst in self.by_chrom.values():
            lst.sort(key=lambda g: g.start)

    def feature_bits(self, chrom: str, start: int, end: int) -> int:
        """Bits for locus [start, end] (inclusive end, matching loci CSV)."""
        bits = 0
        for g in self.by_chrom.get(chrom, ()):
            if g.start - self.reg_len > end:
                break
            if g.end + self.reg_len <= start:
                continue
            bits |= self._gene_bits(g, start, end + 1)
        return bits

    def _gene_bits(self, g: GeneModel, s: int, e: int) -> int:
        bits = 0
        up_s, up_e = g.start - self.reg_len, g.start
        dn_s, dn_e = g.end, g.end + self.reg_len
        if g.strand == "-":
            up_s, up_e, dn_s, dn_e = dn_s, dn_e, up_s, up_e
        if s < up_e and e > up_s:
            bits |= FEAT_UPSTREAM
        if s < dn_e and e > dn_s:
            bits |= FEAT_DNSTREAM
        if e <= g.start or s >= g.end:
            return bits
        in_exon = False
        for ex_s, ex_e in zip(g.exon_starts, g.exon_ends):
            ov_s, ov_e = max(s, int(ex_s)), min(e, int(ex_e))
            if ov_s >= ov_e:
                continue
            in_exon = True
            if g.cds_end > g.cds_start:
                if ov_s < g.cds_start:
                    bits |= FEAT_5UTR if g.strand != "-" else FEAT_3UTR
                if ov_e > g.cds_end:
                    bits |= FEAT_3UTR if g.strand != "-" else FEAT_5UTR
                if max(ov_s, g.cds_start) < min(ov_e, g.cds_end):
                    bits |= FEAT_CDS
            else:
                bits |= FEAT_CDS
        # introns + splice sites between consecutive exons
        for i in range(len(g.exon_starts) - 1):
            int_s, int_e = int(g.exon_ends[i]), int(g.exon_starts[i + 1])
            if s < int_e and e > int_s:
                bits |= FEAT_INTRON
                don_bit = FEAT_5SPLICE if g.strand != "-" else FEAT_3SPLICE
                acc_bit = FEAT_3SPLICE if g.strand != "-" else FEAT_5SPLICE
                if s < int_s + SPLICE_OVERLAP and e > int_s:
                    bits |= don_bit
                if s < int_e and e > int_e - SPLICE_OVERLAP:
                    bits |= acc_bit
        if not in_exon and not (bits & FEAT_INTRON) and s < g.end and e > g.start:
            bits |= FEAT_INTRON
        return bits

    def region_ordinal(self, chrom: str, start: int, end: int,
                       priority: tuple = (FEAT_CDS, FEAT_5UTR, FEAT_3UTR,
                                          FEAT_INTRON, FEAT_UPSTREAM,
                                          FEAT_DNSTREAM)) -> int:
        """Single priority region 0..6 (IG,US,5'UTR,CDS,Intron,3'UTR,DS
        indices per the reference's region rollup order: 0=IG)."""
        bits = self.feature_bits(chrom, start, end)
        if bits == 0:
            return 0
        order = [(FEAT_CDS, 3), (FEAT_5UTR, 2), (FEAT_3UTR, 5),
                 (FEAT_INTRON, 4), (FEAT_UPSTREAM, 1), (FEAT_DNSTREAM, 6)]
        for bit, ordinal in order:
            if bits & bit:
                return ordinal
        return 0


def region_mask_from_ordinals(spec: str) -> int:
    """Parse '2,3 4' style region ordinal lists into a feature-bit mask.
    Ordinal 1 (intergenic) maps to a synthetic IG bit 0x100."""
    mask = 0
    for tok in spec.replace(",", " ").split():
        o = int(tok)
        if o == 1:
            mask |= 0x100
        else:
            mask |= REGION_ORD_BITS.get(o, 0)
    return mask
