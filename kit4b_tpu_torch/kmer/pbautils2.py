"""pbautils processing modes (CPBAutils parity, ngskit4b/pbautils.cpp).

The port's copy of kit4b_tpu/kmer/pbautils2.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Modes (-m, pbautils.cpp:181): 0 PBA to Fasta, 1 Fasta to PBA,
2 concordance over PBA samples, 3 concordance over WIG coverage,
4 allelic variant VCF, 5 allelic genotype VCF, 6 diplotype-only
genotype VCF, 7 deletion genotype VCF, 8 transcribed-segment BED.

PBA byte layout: A<<6|C<<4|G<<2|T, per-allele scores 0-3
(kmer/pba.py). All per-locus walks are vectorized numpy.
"""
from __future__ import annotations

import numpy as np

from .. import dna

# IUPAC code for each allele-presence bitmask (bit0=A,1=C,2=G,3=T)
_IUPAC = np.array(list("NACMGRSVTWYHKDBN"), dtype="U1")
_IUPAC_STR = {
    0: "N", 1: "A", 2: "C", 3: "M", 4: "G", 5: "R", 6: "S", 7: "V",
    8: "T", 9: "W", 10: "Y", 11: "H", 12: "K", 13: "D", 14: "B", 15: "N"}


def _allele_scores(pba: np.ndarray) -> np.ndarray:
    """[L] bytes -> [L, 4] scores (A,C,G,T)."""
    p = np.asarray(pba, np.uint8)
    return np.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                    axis=1)


def pba_to_fasta(chroms: dict, out_path, *, line_len: int = 70) -> int:
    """Mode 0: per-locus consensus base; heterozygous sites emit the
    IUPAC ambiguity over present alleles, uncovered sites 'N'."""
    n = 0
    with open(out_path, "w") as f:
        for name in chroms:
            sc = _allele_scores(chroms[name])
            present = sc > 0
            mask = (present[:, 0] * 1 + present[:, 1] * 2
                    + present[:, 2] * 4 + present[:, 3] * 8)
            seq = "".join(_IUPAC[mask])
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_len):
                f.write(seq[i:i + line_len] + "\n")
            n += 1
    return n


def fasta_to_pba(genome) -> dict:
    """Mode 1: assembly bases -> dirac (score 3) single-allele PBAs;
    ambiguous bases get 0."""
    shifts = np.array([6, 4, 2, 0], np.uint8)
    out = {}
    for i, name in enumerate(genome.names):
        codes = np.asarray(genome.chrom_codes(i))
        ok = codes < 4
        pba = np.zeros(len(codes), np.uint8)
        pba[ok] = (3 << shifts[codes[ok]]).astype(np.uint8)
        out[name] = pba
    return out


def consensus_haploid(pba: np.ndarray) -> np.ndarray:
    """Force bytes to their highest-scoring single allele
    (CPBAutils::ConsensusHaploid): ties pick the first base."""
    sc = _allele_scores(pba)
    best = sc.argmax(axis=1)
    has = sc.max(axis=1) > 0
    shifts = np.array([6, 4, 2, 0], np.uint8)
    return np.where(has, (3 << shifts[best]).astype(np.uint8),
                    0).astype(np.uint8)


def pba_concordance(samples: dict) -> list[dict]:
    """Mode 2: per-chrom coverage/concordance statistics with the FIRST
    sample as reference (pbautils.cpp:1560-1650): counts of loci with
    full / >=50% / no coverage; fully concordant and >=90%-concordant
    loci; mono vs poly allelic."""
    names = list(samples)
    n = len(names)
    out = []
    for chrom in samples[names[0]]:
        mats = np.stack([samples[s][chrom] for s in names])  # [S, L]
        # saturate each present allele's score to 3 so scores don't
        # affect equality (reference promotes to 0xc0/0x30/...)
        sat = np.zeros_like(mats)
        for sh in (6, 4, 2, 0):
            has = ((mats >> sh) & 3) > 0
            sat |= (has * (3 << sh)).astype(np.uint8)
        ref = sat[0]
        covered = sat > 0
        n_cov = covered.sum(axis=0)
        concord = (sat == ref[None, :]) & (ref[None, :] > 0)
        n_conc = concord.sum(axis=0)
        mono = np.isin(sat, (0xC0, 0x30, 0x0C, 0x03))
        full = (n_cov == n) & (ref > 0)
        conc_full = full & (n_conc == n)
        near = full & ~conc_full & (n_conc * 100 >= 90 * n)
        out.append({
            "chrom": chrom, "length": mats.shape[1], "samples": n,
            "full_coverage": int(full.sum()),
            "half_coverage": int(((ref > 0) & (n_cov * 2 > n)
                                  & ~full).sum()),
            "no_coverage": int((ref == 0).sum()),
            "concordant": int(conc_full.sum()),
            "near_concordant": int(near.sum()),
            "mono_alleles": int((conc_full & mono[0]).sum()),
            "poly_alleles": int((conc_full & ~mono[0]).sum())})
    return out


def wig_concordance(cov_samples: dict, *, min_cov: int = 1) -> list[dict]:
    """Mode 3: coverage concordance over per-chrom WIG count vectors —
    loci where all / half / none of the samples have coverage."""
    names = list(cov_samples)
    n = len(names)
    out = []
    for chrom in cov_samples[names[0]]:
        mats = np.stack([np.asarray(cov_samples[s][chrom])
                         for s in names])
        has = mats >= min_cov
        n_cov = has.sum(axis=0)
        out.append({
            "chrom": chrom, "length": mats.shape[1], "samples": n,
            "full_coverage": int((n_cov == n).sum()),
            "half_coverage": int(((n_cov * 2 > n) & (n_cov < n)).sum()),
            "no_coverage": int((n_cov == 0).sum())})
    return out


def write_concordance_csv(path, rows: list[dict]) -> None:
    if not rows:
        return
    cols = list(rows[0])
    with open(path, "w") as f:
        f.write(",".join(f'"{c}"' for c in cols) + "\n")
        for r in rows:
            f.write(",".join(f'"{r[c]}"' if isinstance(r[c], str)
                             else str(r[c]) for c in cols) + "\n")


_VCF_FREQ = {1: "1", 2: "4", 3: "5"}    # score -> frequency code
_BASES = "ACGT"


def allelic_vcf(ref_chroms: dict, sample_chroms: dict, out_path, *,
                ref_name: str = "ref", source: str = "kit4b_tpu"
                ) -> int:
    """Mode 4: allelic variant VCF — loci where the sample's
    dirac/major alleles (0xAA mask) differ from the consensus-haploid
    reference (pbautils.cpp:2626-2740)."""
    n = 0
    with open(out_path, "w") as f:
        f.write(f"##fileformat=VCFv4.1\n##source=pbautils{source}\n"
                f"##reference={ref_name}\n"
                '##INFO=<ID=AF,Number=A,Type=Float,Description='
                '"Allele Frequency">\n'
                '##FORMAT=<ID=DP,Number=1,Type=Integer,Description='
                '"Read Depth">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for chrom in ref_chroms:
            if chrom not in sample_chroms:
                continue
            ref = consensus_haploid(ref_chroms[chrom])
            smp = np.asarray(sample_chroms[chrom])
            both = (ref > 0) & (smp > 0)
            diff = both & ((ref & 0xAA) != (smp & 0xAA))
            ref_sc = _allele_scores(ref)
            smp_sc = _allele_scores(smp)
            for li in np.nonzero(diff)[0]:
                rbase = _BASES[int(ref_sc[li].argmax())]
                alts, freqs = [], []
                tot = 0
                for ai in range(4):
                    s = int(smp_sc[li, ai])
                    if s == 0:
                        continue
                    alts.append(_BASES[ai])
                    freqs.append(_VCF_FREQ[s])
                    tot += s
                af = ",".join(f"{int(fq) / max(tot, 1):.2f}"
                              for fq in freqs)
                f.write(f"{chrom}\t{int(li) + 1}\t.\t{rbase}\t"
                        f"{','.join(alts)}\t50\tPASS\tAF={af}\n")
                n += 1
    return n


def genotype_vcf(ref_chroms: dict, samples: dict, out_path, *,
                 diplotype_only: bool = False,
                 deletions: bool = False,
                 max_na_prop: float = 0.5, min_het_prop: float = 0.0,
                 ref_name: str = "ref") -> int:
    """Modes 5/6/7: genotype VCF with per-sample GT columns. GT per
    sample: 0/0 ref-only, 1/1 single alt allele, 0/1 ref+alt het,
    1/2 two alts, ./. uncovered. diplotype_only keeps only loci where
    some sample is heterozygous; deletions mode emits uncovered-in-
    sample / covered-in-ref runs as <DEL> genotypes."""
    names = list(samples)
    n_out = 0
    with open(out_path, "w") as f:
        f.write(f"##fileformat=VCFv4.1\n##source=pbautils\n"
                f"##reference={ref_name}\n"
                '##FORMAT=<ID=GT,Number=1,Type=String,Description='
                '"Unphased genotypes">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(names) + "\n")
        for chrom in ref_chroms:
            ref = consensus_haploid(ref_chroms[chrom])
            mats = np.stack([samples[s][chrom] for s in names])
            ref_sc = _allele_scores(ref)
            ref_base = ref_sc.argmax(axis=1)
            if deletions:
                # uncovered sample runs at covered ref loci
                covered_ref = ref > 0
                any_del = covered_ref & (mats == 0).any(axis=0)
                for li in np.nonzero(any_del)[0]:
                    gts = ["1/1" if mats[si, li] == 0 else "0/0"
                           for si in range(len(names))]
                    f.write(f"{chrom}\t{int(li) + 1}\t.\t"
                            f"{_BASES[int(ref_base[li])]}\t<DEL>\t50\t"
                            f"PASS\t.\tGT\t" + "\t".join(gts) + "\n")
                    n_out += 1
                continue
            has = np.stack([((mats >> sh) & 3) > 0
                            for sh in (6, 4, 2, 0)], axis=2)  # [S,L,4]
            ref_has = np.take_along_axis(
                has, ref_base[None, :, None].repeat(len(names), 0),
                axis=2)[:, :, 0]
            n_alleles = has.sum(axis=2)
            alt_any = (has.any(axis=2)
                       & (n_alleles > ref_has.astype(np.int64)))
            variant = (ref > 0) & alt_any.any(axis=0)
            na_prop = (mats == 0).mean(axis=0)
            variant &= na_prop <= max_na_prop
            for li in np.nonzero(variant)[0]:
                rb = int(ref_base[li])
                alt_set = sorted({ai for si in range(len(names))
                                  for ai in range(4)
                                  if ai != rb and has[si, li, ai]})
                if not alt_set:
                    continue
                alt_of = {ai: k + 1 for k, ai in enumerate(alt_set)}
                gts = []
                n_het = 0
                for si in range(len(names)):
                    if mats[si, li] == 0:
                        gts.append("./.")
                        continue
                    al = [ai for ai in range(4) if has[si, li, ai]]
                    idx = sorted(alt_of.get(ai, 0) for ai in al)
                    if len(idx) == 1:
                        gts.append(f"{idx[0]}/{idx[0]}")
                    else:
                        gts.append(f"{idx[0]}/{idx[-1]}")
                        n_het += 1
                if diplotype_only and n_het == 0:
                    continue
                if n_het / max(len(names), 1) < min_het_prop:
                    continue
                f.write(f"{chrom}\t{int(li) + 1}\t.\t{_BASES[rb]}\t"
                        + ",".join(_BASES[a] for a in alt_set)
                        + "\t50\tPASS\t.\tGT\t" + "\t".join(gts) + "\n")
                n_out += 1
    return n_out


def transcribed_bed(samples: dict, out_path, *, min_len: int = 1) -> int:
    """Mode 8: union of covered segments over all samples -> BED
    (transcribed regions)."""
    names = list(samples)
    n = 0
    with open(out_path, "w") as f:
        for chrom in samples[names[0]]:
            cov = np.zeros(len(samples[names[0]][chrom]), bool)
            for s in names:
                cov |= np.asarray(samples[s][chrom]) > 0
            d = np.diff(cov.astype(np.int8))
            starts = np.nonzero(d == 1)[0] + 1
            ends = np.nonzero(d == -1)[0] + 1
            if cov[0]:
                starts = np.concatenate([[0], starts])
            if cov[-1]:
                ends = np.concatenate([ends, [len(cov)]])
            for s, e in zip(starts, ends):
                if e - s >= min_len:
                    n += 1
                    f.write(f"{chrom}\t{int(s)}\t{int(e)}\tseg{n}\t0\t+\n")
    return n
