"""gbsmapsnps + dgts: GBS SNP -> PBA haplotype mapping and DGT/QTL
allele analysis.

The port's copy of kit4b_tpu/kmer/gbs.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Capability parity with `ngskit4b gbsmapsnps` (ngskit4b/GBSmapSNPs.cpp
CGBSmapSNPs: LoadGBSSNPs field layout, SNPs2Alleles encoding, founder
haplotype calling, matrix combine mode) and the QTL core of
`ngskit4b dgts` (ngskit4b/CDGTvQTLs.cpp: per-QTL-locus sample PBA allele
reporting with low-coverage / homozygosity characterisation).
"""
from __future__ import annotations

import csv
from collections import defaultdict

import numpy as np

# haplotype call codes in the matrix (reference reports Fa/Fb founder
# bit-vector membership; -1 when the progeny had no canonical alleles)
CALL_NA, CALL_FA, CALL_FB, CALL_BOTH = -1, 1, 2, 3

_BASE_SLOT = {"a": 3, "c": 2, "g": 1, "t": 0}   # PBA byte: A<<6|C<<4|G<<2|T


def snps_to_alleles(s: str, major_only: bool = False) -> int:
    """Diploid base-pair text (e.g. "AA", "AG", "NA") -> packed PBA
    allele byte (GBSmapSNPs.cpp SNPs2Alleles): homozygous = dirac score
    3 in that base's slot, heterozygous = score 2 in both slots."""
    s = (s or "").strip().lower()
    if not s or s == "na" or s[0] not in _BASE_SLOT:
        return 0
    if len(s) == 1:
        s = s + s
    if s[1] not in _BASE_SLOT:
        return 0
    if major_only and s[0] != s[1]:
        return 0
    if s[0] == s[1]:
        return 3 << (2 * _BASE_SLOT[s[0]])
    return (2 << (2 * _BASE_SLOT[s[0]])) | (2 << (2 * _BASE_SLOT[s[1]]))


def load_chrom_map(path) -> dict:
    """Alias -> reference chromosome name mapping CSV (col1=alias,
    col2=refname; header tolerated). 3-field files (LoadNM,
    GBSmapSNPs.cpp:439: fromChrom,toChrom,size) also carry the target
    chromosome size, returned as {alias: (refname, size)}; loci beyond
    the size are clamped by the caller as the reference does (:900)."""
    out = {}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 2 or row[0].strip('"').lower() in ("alias",
                                                             "chrom"):
                continue
            alias = row[0].strip().strip('"')
            ref = row[1].strip().strip('"')
            if len(row) >= 3 and row[2].strip().isdigit():
                out[alias] = (ref, int(row[2]))
            else:
                out[alias] = ref
    return out


def map_gbs_snps(gbs_csv, chrom_map: dict | None = None):
    """gbsmapsnps -m0: GBS SNP genotyping CSV -> founder haplotype
    matrix.

    Input layout (LoadGBSSNPs): header row names founders in fields 4,5
    and progenies in fields 6..n; data rows are (chrom+loci, chrom,
    loci, Fa bases, Fb bases, F4_1.., F4_n).

    Returns (founder_names, progeny_names, rows) where rows is a sorted
    list of (chrom, loci, [call per progeny]).
    """
    with open(gbs_csv, newline="") as f:
        rdr = csv.reader(f)
        header = next(rdr)
        if len(header) < 6:
            raise ValueError("GBS SNP file needs >=6 fields")
        fa_name, fb_name = header[3].strip(), header[4].strip()
        progenies = [h.strip() for h in header[5:]]
        rows = []
        for row in rdr:
            if len(row) != len(header):
                continue
            chrom, loci = row[1].strip(), int(row[2])
            if chrom_map is not None:
                if chrom not in chrom_map:
                    continue
                mapped = chrom_map[chrom]
                if isinstance(mapped, tuple):
                    chrom, size = mapped
                    loci = min(loci, size)  # clamp (GBSmapSNPs.cpp:900)
                else:
                    chrom = mapped
            fa = snps_to_alleles(row[3], major_only=True)
            fb = snps_to_alleles(row[4], major_only=True)
            if fa == 0 or fb == 0 or fa == fb:   # non-discriminating
                continue
            calls = []
            for cell in row[5:]:
                al = snps_to_alleles(cell)
                if al == 0:
                    calls.append(CALL_NA)
                elif al == fa:
                    calls.append(CALL_FA)
                elif al == fb:
                    calls.append(CALL_FB)
                elif al == ((fa | fb) & 0xAA):   # het of both founders
                    calls.append(CALL_BOTH)
                else:
                    calls.append(CALL_NA)
            rows.append((chrom, loci, calls))
    rows.sort(key=lambda r: (r[0], r[1]))
    return (fa_name, fb_name), progenies, rows


def write_haplotype_matrix(path, founders, progenies, rows,
                           expr_id: int = 1) -> None:
    with open(path, "w") as f:
        f.write('"ExprID","Chrom","Loci","Fa","Fb",'
                + ",".join(f'"{p}"' for p in progenies) + "\n")
        for chrom, loci, calls in rows:
            f.write(f'{expr_id},"{chrom}",{loci},"{founders[0]}",'
                    f'"{founders[1]}",'
                    + ",".join(str(c) for c in calls) + "\n")


def read_haplotype_matrix(path):
    with open(path, newline="") as f:
        rdr = csv.reader(f)
        header = next(rdr)
        progenies = [h.strip().strip('"') for h in header[5:]]
        founders = None
        rows = []
        for row in rdr:
            founders = (row[3].strip('"'), row[4].strip('"'))
            rows.append((row[1].strip('"'), int(row[2]),
                         [int(c) for c in row[5:]]))
    return founders, progenies, rows


def combine_matrices(m1_path, m2_path, out_path) -> dict:
    """gbsmapsnps -m1: combine two haplotype matrices, reporting
    per-locus consistency. Calls that agree (or where one side is NA)
    are kept; conflicts are output as NA and counted."""
    f1, p1, r1 = read_haplotype_matrix(m1_path)
    f2, p2, r2 = read_haplotype_matrix(m2_path)
    if p1 != p2:
        raise ValueError("matrices have different progeny columns")
    m2 = {(c, l): calls for c, l, calls in r2}
    stats = {"shared_loci": 0, "m1_only": 0, "m2_only": 0,
             "agree": 0, "conflict": 0, "filled": 0}
    out_rows = []
    seen = set()
    for chrom, loci, c1 in r1:
        key = (chrom, loci)
        c2 = m2.get(key)
        if c2 is None:
            stats["m1_only"] += 1
            out_rows.append((chrom, loci, c1))
            continue
        seen.add(key)
        stats["shared_loci"] += 1
        merged = []
        for a, b in zip(c1, c2):
            if a == b:
                if a != CALL_NA:
                    stats["agree"] += 1
                merged.append(a)
            elif a == CALL_NA or b == CALL_NA:
                stats["filled"] += 1
                merged.append(a if b == CALL_NA else b)
            else:
                stats["conflict"] += 1
                merged.append(CALL_NA)
        out_rows.append((chrom, loci, merged))
    for chrom, loci, c2 in r2:
        if (chrom, loci) not in seen and (chrom, loci) not in \
                {(c, l) for c, l, _ in r1}:
            stats["m2_only"] += 1
            out_rows.append((chrom, loci, c2))
    out_rows.sort(key=lambda r: (r[0], r[1]))
    write_haplotype_matrix(out_path, f1, p1, out_rows)
    return stats


def write_progeny_reports(base_path, founders, progenies, rows,
                          expr_id: int = 1) -> dict:
    """ReportHaplotypesByProgeny (GBSmapSNPs.cpp:1108-1200): one CSV per
    progeny readset named `<base>.progeny.<ExprID>.<readset>.csv` plus a
    combined `.all.csv`; columns are per-founder 0/1 presence bits at
    each informative locus (NA loci are skipped, as the reference skips
    !NumProgenyFounders rows)."""
    fa, fb = founders
    written = {}

    def rows_for(pi):
        out = []
        for chrom, loci, calls in rows:
            c = calls[pi]
            if c in (CALL_NA, 0):
                continue
            out.append((chrom, loci, int(bool(c & 1)), int(bool(c & 2))))
        return out

    def emit(path, sel):
        with open(path, "w") as f:
            f.write(f'"ExprID","Progeny","Chrom","Loci",'
                    f'"Fndr:{fa}","Fndr:{fb}"\n')
            k = 0
            for pi in sel:
                for chrom, loci, ba, bb in rows_for(pi):
                    f.write(f'{expr_id},"{progenies[pi]}","{chrom}",'
                            f'{loci},{ba},{bb}\n')
                    k += 1
        return k

    for pi, pname in enumerate(progenies):
        p = f"{base_path}.progeny.{expr_id}.{pname}.csv"
        written[p] = emit(p, [pi])
    p = f"{base_path}.progeny.{expr_id}.all.csv"
    written[p] = emit(p, range(len(progenies)))
    return written


# ---------------------------------------------------------------- dgts

def load_qtl_csv(path):
    """QTL alleles CSV: chrom, loci, allele base (header tolerated)."""
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 3 or row[0].lower() in ("chrom", '"chrom"'):
                continue
            out.append((row[0].strip().strip('"'), int(row[1]),
                        row[2].strip().strip('"').upper()))
    return out


def analyse_qtls(qtls: list, sample_pbas: dict,
                 min_cov_prop: float = 0.8,
                 homoz_prop: float = 0.95) -> list[dict]:
    """dgts -m0 QTL core: for each QTL locus, pull every sample's PBA
    allele scores, then characterise the locus (CDGTvQTLs -k/-p):
    low_coverage when < min_cov_prop of samples have any allele scored,
    homozygous when >= homoz_prop of covered samples share the QTL
    allele as their top call.

    sample_pbas: sample -> {chrom: PBA byte array}.
    """
    from .pba import unpack_pba

    base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    results = []
    samples = list(sample_pbas)
    for chrom, loci, allele in qtls:
        per = {}
        n_cov = n_match = 0
        for s in samples:
            chroms = sample_pbas[s]
            if chrom not in chroms or loci >= len(chroms[chrom]):
                per[s] = None
                continue
            scores = unpack_pba(
                np.asarray([chroms[chrom][loci]], np.uint8))[0]
            per[s] = scores
            if scores.max() == 0:
                continue
            n_cov += 1
            if allele in base_idx and \
                    int(np.argmax(scores)) == base_idx[allele]:
                n_match += 1
        cov_p = n_cov / max(len(samples), 1)
        results.append({
            "chrom": chrom, "loci": loci, "allele": allele,
            "samples": len(samples), "covered": n_cov,
            "matching": n_match,
            "low_coverage": cov_p < min_cov_prop,
            "homozygous": n_cov > 0 and n_match / n_cov >= homoz_prop,
            "scores": per})
    return results


def write_qtl_csv(path, results: list) -> None:
    with open(path, "w") as f:
        f.write('"Chrom","Loci","Allele","Samples","Covered",'
                '"Matching","LowCoverage","Homozygous"\n')
        for r in results:
            f.write(f'"{r["chrom"]}",{r["loci"]},"{r["allele"]}",'
                    f'{r["samples"]},{r["covered"]},{r["matching"]},'
                    f'{int(r["low_coverage"])},{int(r["homozygous"])}\n')
