"""DGT vs QTL allele analysis (CDGTvQTLs parity, ngskit4b/CDGTvQTLs.cpp).

The port's copy of kit4b_tpu/kmer/dgtqtl.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Modes (-m): 0 QTL-only, 1 DGT and QTL loci. Per locus the engine pulls
every sample's PBA byte, saturates allele scores to presence bits
(AnalyseInstance:2665-2674), builds the 256-bin diplotype distribution,
and characterises the locus (:2680-2740): Coverage (non-zero samples),
Grp1Prop/Grp2Prop/GrpNProp over the two highest-frequency diplotypes,
low-coverage / mono-vs-poly-allelic / homozygous-vs-heterozygous /
reference-mismatch flags. Output columns mirror the reference CSV
(:2750-2760).

The per-locus loop is vectorized across samples with numpy.
"""
from __future__ import annotations

import csv as _csv

import numpy as np

_BASES = "ACGT"


def diplotype_txt(pba: int) -> str:
    """PBA presence byte -> diplotype text like 'A/G' (Diplotype2Txt)."""
    present = [b for i, b in enumerate(_BASES)
               if pba & (0xC0 >> (2 * i))]
    if not present:
        return "-/-"
    if len(present) == 1:
        return f"{present[0]}/{present[0]}"
    return "/".join(present[:2]) + ("+" if len(present) > 2 else "")


def load_qtl_alleles(path) -> list[dict]:
    """CSV QTLs: chrom, loci, ref allele, alt allele (LoadQTLs field
    subset)."""
    out = []
    with open(path, newline="") as f:
        for row in _csv.reader(f):
            if len(row) < 3:
                continue
            chrom = row[0].strip().strip('"')
            try:
                loci = int(row[1])
            except ValueError:
                continue
            ref = row[2].strip().strip('"').upper()[:1]
            alt = row[3].strip().strip('"').upper()[:1] if len(row) > 3 \
                else ""
            out.append({"chrom": chrom, "loci": loci, "ref": ref,
                        "alt": alt, "qtl": True, "dgt": False})
    return out


def load_dgt_loci(path) -> list[dict]:
    """CSV DGTs from callhaplotypes mode 5 (RowID, Chrom, Loci, Allele,
    Group, FMeasure) or generic chrom,loci[,allele]."""
    out = []
    with open(path, newline="") as f:
        for row in _csv.reader(f):
            if len(row) < 2:
                continue
            cells = [c.strip().strip('"') for c in row]
            # callhaplotypes mode-5 layout has RowID first
            if cells[0].isdigit() and len(cells) >= 4 and \
                    not cells[1].isdigit():
                chrom, loci_s, allele = cells[1], cells[2], cells[3]
            else:
                chrom, loci_s = cells[0], cells[1]
                allele = cells[2] if len(cells) > 2 else ""
            if not loci_s.isdigit():
                continue
            out.append({"chrom": chrom, "loci": int(loci_s),
                        "ref": allele.upper()[:1], "alt": "",
                        "qtl": False, "dgt": True})
    return out


def _saturate(col: np.ndarray) -> np.ndarray:
    sat = np.zeros_like(col)
    for sh in (6, 4, 2, 0):
        has = ((col >> sh) & 3) > 0
        sat |= (has * (3 << sh)).astype(np.uint8)
    return sat


def analyse_dgt_qtls(instances: list[dict], ref_pba: dict,
                     sample_pbas: dict, *, mode: int = 0,
                     min_coverage: float = 0.8,
                     homoz_prop: float = 0.95) -> list[dict]:
    """AnalyseInstance over every loaded DGT/QTL locus. ref_pba:
    {chrom: bytes} for the assembly reference; sample_pbas:
    sample -> {chrom: bytes}."""
    samples = list(sample_pbas)
    n = len(samples)
    out = []
    for inst in instances:
        if mode == 0 and not inst["qtl"]:
            continue
        chrom, loci = inst["chrom"], inst["loci"]
        ref_c = ref_pba.get(chrom)
        if ref_c is None or loci >= len(ref_c):
            continue
        ref = int(_saturate(np.asarray([ref_c[loci]], np.uint8))[0])
        col = np.asarray([sample_pbas[s][chrom][loci]
                          if chrom in sample_pbas[s]
                          and loci < len(sample_pbas[s][chrom]) else 0
                          for s in samples], np.uint8)
        sat = _saturate(col)
        dist = np.bincount(sat, minlength=256)
        n_nocov = int(dist[0])
        coverage = 1.0 - n_nocov / max(n, 1)
        covered = max(n - n_nocov, 1)
        nz = dist.copy()
        nz[0] = 0
        hi = int(nz.argmax())
        nz[hi] = 0
        nxt = int(nz.argmax()) if nz.any() else 0
        lo_cov = coverage < min_coverage
        if lo_cov:
            hi = nxt = 0
            g1 = g2 = gn = 0.0
        else:
            g1 = float(dist[hi]) / covered
            g2 = float(dist[nxt]) / covered if nxt else 0.0
            gn = max(1.0 - (g1 + g2), 0.0)
        mono = (not lo_cov) and hi in (0xC0, 0x30, 0x0C, 0x03)
        qtl_ref = 0
        qtl_ref_mismatch = False
        if inst["qtl"] and inst["ref"] in _BASES:
            qtl_ref = 0xC0 >> (2 * _BASES.index(inst["ref"]))
            qtl_ref_mismatch = ref != qtl_ref
        out.append({
            "chrom": chrom, "loci": loci,
            "ref_diplotype": diplotype_txt(ref),
            "loci_type": (3 if inst["qtl"] and inst["dgt"]
                          else 2 if inst["qtl"] else 1),
            "qtl_ref": diplotype_txt(qtl_ref) if inst["qtl"] else "-/-",
            "qtl_alt": diplotype_txt(
                0xC0 >> (2 * _BASES.index(inst["alt"])))
            if inst["qtl"] and inst["alt"] in _BASES else "-/-",
            "characterised": 0 if lo_cov else 1,
            "coverage": coverage,
            "grp1_prop": g1, "grp1": diplotype_txt(hi),
            "grp2_prop": g2, "grp2": diplotype_txt(nxt),
            "grpn_prop": gn,
            "qtl_ref_mismatch": int(qtl_ref_mismatch),
            "samples_ref_mismatch": int((not lo_cov) and hi != ref),
            "homozygous": int((not lo_cov) and g1 >= homoz_prop),
            "heterozygous": int((not lo_cov) and g1 < homoz_prop),
            "poly_allelic": int((not lo_cov) and not mono),
            "mono_allelic": int(mono)})
    return out


def write_dgt_qtl_csv(path, rows: list[dict]) -> None:
    """Reference CSV layout (CDGTvQTLs.cpp:2750)."""
    with open(path, "w") as f:
        f.write('"Chrom","Loci","RefDiplotype","LociType","QTLRef",'
                '"QTLAlt","Characterised","Coverage","Grp1Prop","Grp1",'
                '"Grp2Prop","Grp2","GrpNProp","QTLRefMismatch",'
                '"SamplesRefMismatch","Homozygous","Heterozygous",'
                '"PolyAllelic","MonoAllelic"\n')
        for r in rows:
            f.write(f'"{r["chrom"]}",{r["loci"]},"{r["ref_diplotype"]}",'
                    f'{r["loci_type"]},"{r["qtl_ref"]}","{r["qtl_alt"]}",'
                    f'{r["characterised"]},{r["coverage"]:.3f},'
                    f'{r["grp1_prop"]:.3f},"{r["grp1"]}",'
                    f'{r["grp2_prop"]:.3f},"{r["grp2"]}",'
                    f'{r["grpn_prop"]:.3f},{r["qtl_ref_mismatch"]},'
                    f'{r["samples_ref_mismatch"]},{r["homozygous"]},'
                    f'{r["heterozygous"]},{r["poly_allelic"]},'
                    f'{r["mono_allelic"]}\n')
