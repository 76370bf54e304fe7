"""SNP-derived format converters and sequence tools.

The port's copy of kit4b_tpu/tools/snpsfmt.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Covers four reference subprocesses over kalign SNP/DiSNP/TriSNP CSVs:
  - snps2pgsnps (ngskit4b/SNPs2pgSNPs.cpp): SNP CSV -> UCSC pgSnp track
    (or VCF via align.snp.write_snps_vcf)
  - lochap2bed  (ngskit4b/LocHap2Bed.cpp): Di/TriSNP local haplotypes -> BED
  - markerseqs  (ngskit4b/MarkerSeq.cpp): marker flank sequences around SNPs
  - repassemb   (ngskit4b/repassemb.cpp): replace assembly bases with SNP
    major alleles
"""
from __future__ import annotations

import csv

import numpy as np

from .. import dna

_BASES = "ACGTN"


def read_snps_csv(path) -> list[dict]:
    """Parse the kalign SNP CSV (align/snp.py write_snps_csv layout)."""
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            cnts = [int(row[f"MMBase{b}"]) for b in "ACGTN"]
            out.append({
                "chrom": row["Chrom"], "loci": int(row["StartLoci"]),
                "ref": row["RefBase"], "counts": cnts,
                "bases": int(row["Bases"]), "mm": int(row["Mismatches"]),
                "pvalue": float(row["PValue"]),
            })
    return out


def write_pgsnp(path, snps: list[dict], *, track: str = "kit4b_tpu",
                assembly: str = "assembly", min_count: int = 1) -> None:
    """UCSC pgSnp: chrom start end alleles alleleCount alleleFreq
    alleleScores (SNPs2pgSNPs.cpp:1960 track header)."""
    with open(path, "w") as f:
        f.write(f'track type=pgSnp visibility=3 db={assembly} '
                f'name="{track}" description="kit4b_tpu SNPs"\n')
        for s in snps:
            ref_i = _BASES.index(s["ref"])
            alleles, freqs = [], []
            ref_cnt = s["bases"] - s["mm"]
            if ref_cnt >= min_count:
                alleles.append(s["ref"])
                freqs.append(ref_cnt)
            for b, c in zip(_BASES[:4], s["counts"]):
                if b != s["ref"] and c >= min_count:
                    alleles.append(b)
                    freqs.append(c)
            if not alleles:
                continue
            f.write(f'{s["chrom"]}\t{s["loci"]}\t{s["loci"]+1}\t'
                    f'{"/".join(alleles)}\t{len(alleles)}\t'
                    f'{",".join(map(str, freqs))}\t'
                    f'{",".join("0" for _ in alleles)}\n')


def lochap_to_bed(inpath, outpath) -> int:
    """Di/TriSNP haplotype CSV (align/snp.py write_multisnps_csv:
    name_ID,Chrom,Loci "a|b[|c]",Alleles,Counts) -> BED spans."""
    n = 0
    with open(inpath, newline="") as f, open(outpath, "w") as o:
        rd = csv.reader(f)
        header = next(rd)
        for row in rd:
            chrom = row[1]
            loci = [int(x) for x in row[2].split("|")]
            alleles = row[3]
            counts = row[4] if len(row) > 4 else "0"
            score = min(int(str(counts).split("|")[0] or 0), 1000)
            o.write(f"{chrom}\t{min(loci)}\t{max(loci)+1}\t{alleles}\t"
                    f"{score}\t+\n")
            n += 1
    return n


def marker_seqs(genome, snps: list[dict], flank: int = 25) -> list[dict]:
    """Extract 5' flank / SNP base / 3' flank marker sequences around SNP
    loci (MarkerSeq.cpp: re-fetch flanks from the assembly)."""
    name_to_ci = {n: i for i, n in enumerate(genome.names)}
    out = []
    for i, s in enumerate(snps, 1):
        ci = name_to_ci.get(s["chrom"])
        if ci is None:
            continue
        st = int(genome.starts[ci])
        ln = int(genome.lengths[ci])
        lo = max(0, s["loci"] - flank)
        hi = min(ln, s["loci"] + flank + 1)
        seq = genome.seq[st + lo: st + hi]
        mid = s["loci"] - lo
        alt = int(np.argmax(s["counts"][:4]))
        out.append({
            "id": i, "chrom": s["chrom"], "loci": s["loci"],
            "five": dna.decode(seq[:mid]), "ref": s["ref"],
            "alt": _BASES[alt], "three": dna.decode(seq[mid + 1:]),
        })
    return out


def write_marker_seqs_csv(path, markers: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"MarkerID","Chrom","Loci","5pFlank","RefBase","AltBase",'
                '"3pFlank"\n')
        for m in markers:
            f.write(f'{m["id"]},"{m["chrom"]}",{m["loci"]},"{m["five"]}",'
                    f'"{m["ref"]}","{m["alt"]}","{m["three"]}"\n')


def replace_assembly_alleles(genome, snps: list[dict],
                             *, min_prop: float = 0.5) -> int:
    """repassemb: in-place replace reference bases with the major non-ref
    allele where it holds > min_prop of the coverage. Returns #replaced."""
    name_to_ci = {n: i for i, n in enumerate(genome.names)}
    n = 0
    for s in snps:
        ci = name_to_ci.get(s["chrom"])
        if ci is None:
            continue
        alt = int(np.argmax(s["counts"][:4]))
        if s["bases"] and s["counts"][alt] / s["bases"] > min_prop:
            genome.seq[int(genome.starts[ci]) + s["loci"]] = alt
            n += 1
    return n
