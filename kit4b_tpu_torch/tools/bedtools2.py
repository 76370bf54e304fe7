"""BED/GFF/GTF filtering and merging tools, the port's copy of
kit4b_tpu/tools/bedtools2.py (host only; tests/test_torch_rehomed.py
holds it equal to the original statement for statement): bedfilter,
bedmerge, gfffilter and gtffilter.
"""
from __future__ import annotations

import re

from ..io.bed import BedFeature, BedFile, write_bed
from ..io.biobed import RegionClassifier, load_gene_bed


def bed_filter(in_path, out_path, *, strand: int = 0, min_len: int = 1,
               max_len: int = 20, chrom_exclude: list | None = None,
               chrom_include: list | None = None) -> int:
    """BEDFilter: retain features passing strand (0 any, 1 '+', 2 '-'),
    length range, and chrom regex filters (BEDFilter.cpp args)."""
    exc = [re.compile(p) for p in (chrom_exclude or [])]
    inc = [re.compile(p) for p in (chrom_include or [])]
    want = {0: None, 1: "+", 2: "-"}[strand]
    kept = []
    for ft in BedFile.load(in_path).features:
        if want and ft.strand != want:
            continue
        ln = ft.end - ft.start
        if ln < min_len or ln > max_len:
            continue
        if exc and any(p.search(ft.chrom) for p in exc):
            continue
        if inc and not any(p.search(ft.chrom) for p in inc):
            continue
        kept.append(ft)
    write_bed(out_path, kept)
    return len(kept)


def bed_merge(in_paths: list, out_path, *, mode: int = 0, strand: int = 0,
              region: int = 0, min_len: int = 20, join_len: int = 1,
              chrom_exclude: list | None = None,
              chrom_include: list | None = None,
              gene_bed=None, reg_len: int = 2000) -> int:
    """BEDMerge: union-merge features across BED files (BEDMerge.cpp).
    mode 0 strand-independent, 1 strand-dependent; join_len gap joining;
    region (1:Intergenic,2:Exons,3:Introns,4:CDS,5:UTRs,6:5'UTR,7:3'UTR)
    retains merged features overlapping that region of gene_bed."""
    exc = [re.compile(p) for p in (chrom_exclude or [])]
    inc = [re.compile(p) for p in (chrom_include or [])]
    want = {0: None, 1: "+", 2: "-"}[strand]
    per: dict[tuple, list] = {}
    for path in in_paths:
        for ft in BedFile.load(path).features:
            if want and ft.strand != want:
                continue
            if exc and any(p.search(ft.chrom) for p in exc):
                continue
            if inc and not any(p.search(ft.chrom) for p in inc):
                continue
            key = (ft.chrom, ft.strand if mode == 1 else "+")
            per.setdefault(key, []).append((ft.start, ft.end))
        # merge with gap joining
    cls = None
    if region and gene_bed:
        cls = RegionClassifier(load_gene_bed(gene_bed), reg_len)
    merged: list[BedFeature] = []
    n = 0
    for (chrom, strd) in sorted(per):
        iv = sorted(per[(chrom, strd)])
        cur_s, cur_e = iv[0]
        for s, e in iv[1:] + [(1 << 62, 1 << 62)]:
            if s <= cur_e + join_len:
                cur_e = max(cur_e, e)
            else:
                if cur_e - cur_s >= min_len and \
                        _region_ok(cls, chrom, cur_s, cur_e, region):
                    n += 1
                    merged.append(BedFeature(chrom, cur_s, cur_e,
                                             f"m{n}", 0, strd))
                cur_s, cur_e = s, e
    write_bed(out_path, merged)
    return len(merged)


def _region_ok(cls, chrom, start, end, region: int) -> bool:
    if not region or cls is None:
        return True
    from ..io import biobed as bb
    bits = cls.feature_bits(chrom, start, end - 1)
    checks = {
        1: bits == 0,
        2: bool(bits & (bb.FEAT_5UTR | bb.FEAT_CDS | bb.FEAT_3UTR)),
        3: bool(bits & bb.FEAT_INTRON),
        4: bool(bits & bb.FEAT_CDS),
        5: bool(bits & (bb.FEAT_5UTR | bb.FEAT_3UTR)),
        6: bool(bits & bb.FEAT_5UTR),
        7: bool(bits & bb.FEAT_3UTR),
    }
    return checks.get(region, True)


GFF_GENE_CLASSES = {
    0: None,
    1: ("gene", "mRNA", "CDS", "exon", "protein"),
    2: ("transposable_element", "transposable_element_gene", "transposon"),
    3: ("miRNA", "miRNA_primary_transcript"),
    4: ("snoRNA",),
    5: ("tRNA",),
    6: ("pseudogene", "pseudogenic_transcript", "pseudogenic_exon"),
}


def gff_filter(in_path, out_path, *, mode: int = 0, genes: int = 1,
               name_attr: str = "Name", scale: float = 1.0) -> int:
    """GFFfilter: retain records of a gene class (GFFfilter.cpp -g),
    writing GFF (mode 0) or BED (mode 1)."""
    from ..io.gff import read_gff
    classes = GFF_GENE_CLASSES.get(genes)
    kept = []
    for rec in read_gff(in_path, gtf=False):
        if classes is not None:
            if genes == 1:
                # protein genes: exclude records typed as any other class
                other = any(rec.ftype in GFF_GENE_CLASSES[c]
                            for c in (2, 3, 4, 5, 6))
                if other or rec.ftype not in classes:
                    continue
            elif rec.ftype not in classes:
                continue
        kept.append(rec)
    with open(out_path, "w") as f:
        if mode == 0:
            f.write("##gff-version 3\n")
            for r in kept:
                attrs = ";".join(f"{k}={v}" for k, v in r.attrs.items())
                score = "." if r.score is None else f"{r.score:g}"
                f.write(f"{r.seqid}\t{r.source}\t{r.ftype}\t{r.start}\t"
                        f"{r.end}\t{score}\t{r.strand}\t{r.phase}\t"
                        f"{attrs}\n")
        else:
            for r in kept:
                name = r.attrs.get(name_attr, r.attrs.get("ID", r.ftype))
                score = int((r.score or 0) * scale)
                f.write(f"{r.seqid}\t{r.start - 1}\t{r.end}\t{name}\t"
                        f"{min(score, 1000)}\t{r.strand}\n")
    return len(kept)


def gtf_filter(in_path, out_path, *, map_path=None) -> int:
    """GTFfilter: normalise GTF records, optionally remapping contig
    names to chromosomes via a 2-column map file (GTFfilter.cpp -I)."""
    from ..io.gff import read_gff
    cmap = {}
    if map_path:
        with open(map_path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if len(parts) >= 2:
                    cmap[parts[0]] = parts[1]
    n = 0
    with open(out_path, "w") as f:
        for r in read_gff(in_path, gtf=True):
            seqid = cmap.get(r.seqid, r.seqid)
            attrs = " ".join(f'{k} "{v}";' for k, v in r.attrs.items())
            score = "." if r.score is None else f"{r.score:g}"
            f.write(f"{seqid}\t{r.source}\t{r.ftype}\t{r.start}\t{r.end}\t"
                    f"{score}\t{r.strand}\t{r.phase}\t{attrs}\n")
            n += 1
    return n
