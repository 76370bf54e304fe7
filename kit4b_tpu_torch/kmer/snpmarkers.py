"""snpmarkers: cross-cultivar SNP-derived marker identification.

The port's copy of kit4b_tpu/kmer/snpmarkers.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Capability parity with `ngskit4b snpmarkers` (ngskit4b/gensnpmarkers.cpp +
Markers.cpp: CMarkers::LoadSNPFile:693, AddImputedAlignments:880): per-
cultivar SNP CSVs (kalign -S output) are joined by locus; a marker is a locus
where at least one cultivar shows a near-fixed non-reference allele while
every other cultivar is covered and near-fixed on a DIFFERENT base (the
reference's inter-cultivar allele divergence test with coverage imputation:
cultivars with no SNP at a locus count as reference-fixed when the locus is
covered).

Inputs are our SNP CSV format (align/snp.py write_snps_csv columns).
"""
from __future__ import annotations

import csv
from collections import defaultdict
from dataclasses import dataclass

_BASES = "ACGT"


@dataclass
class SnpSite:
    chrom: str
    loci: int
    ref_base: str
    counts: dict          # base -> count (incl ref)
    tot: int


@dataclass
class SnpMarker:
    chrom: str
    loci: int
    ref_base: str
    alleles: dict         # cultivar -> (base, purity)


def load_snp_csv(path) -> dict:
    """Parse our SNP CSV into {(chrom, loci): SnpSite}."""
    out = {}
    with open(path) as f:
        rd = csv.DictReader(f)
        for row in rd:
            chrom = row["Chrom"]
            loci = int(row["StartLoci"])
            counts = {b: int(row[f"MMBase{b}"]) for b in _BASES}
            tot = int(row["Bases"])
            ref = row["RefBase"]
            counts[ref] = tot - int(row["Mismatches"])
            out[(chrom, loci)] = SnpSite(chrom, loci, ref, counts, tot)
    return out


def find_snp_markers(cultivar_csvs: dict, *, min_cov: int = 5,
                     min_purity: float = 0.8,
                     require_all_covered: bool = False) -> list[SnpMarker]:
    """cultivar name -> SNP CSV path. Returns divergent-allele markers.

    A locus qualifies when >= 2 cultivars resolve to distinct near-fixed
    bases (purity >= min_purity). Cultivars without a SNP row at the locus
    are imputed as reference-fixed (AddImputedAlignments semantics) — they
    participate as the reference allele.
    """
    sites = {c: load_snp_csv(p) for c, p in cultivar_csvs.items()}
    cultivars = list(sites)
    all_loci = set()
    for s in sites.values():
        all_loci.update(s.keys())

    markers: list[SnpMarker] = []
    for key in sorted(all_loci):
        chrom, loci = key
        ref = None
        alleles = {}
        ok = True
        for c in cultivars:
            site = sites[c].get(key)
            if site is None:
                alleles[c] = ("REF", 1.0)  # imputed reference-fixed
                continue
            ref = site.ref_base
            if site.tot < min_cov:
                ok = False
                break
            base, cnt = max(site.counts.items(), key=lambda kv: kv[1])
            purity = cnt / max(1, sum(site.counts.values()))
            if purity < min_purity:
                ok = False
                break
            alleles[c] = (base, purity)
        if not ok or ref is None:
            continue
        resolved = {c: (ref if b == "REF" else b, p)
                    for c, (b, p) in alleles.items()}
        distinct = {b for b, _ in resolved.values()}
        if len(distinct) >= 2:
            markers.append(SnpMarker(chrom, loci, ref, resolved))
    return markers


def write_snp_markers_csv(path, markers: list[SnpMarker],
                          cultivars: list[str]) -> None:
    with open(path, "w") as f:
        f.write('"MarkerID","Chrom","Loci","RefBase",'
                + ",".join(f'"{c}","{c}_purity"' for c in cultivars) + "\n")
        for i, m in enumerate(markers, start=1):
            cols = []
            for c in cultivars:
                b, p = m.alleles.get(c, ("?", 0.0))
                cols.append(f'"{b}",{p:.3f}')
            f.write(f'{i},"{m.chrom}",{m.loci},"{m.ref_base}",'
                    + ",".join(cols) + "\n")
