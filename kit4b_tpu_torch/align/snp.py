"""SNP calling from accepted alignments (kalign SNP phase), the port's
own copy of the caller and writers of kit4b_tpu/align/snp.py that
`kalign -S` runs.

Mirrors the reference CKAligner::ProcessSNPs/OutputSNPs
(ngskit4b/KAligner.cpp:8168, :7098):

  - base pileup over accepted, uniquely-aligned reads (substitutions-only
    alignments mean read base j stacks on genome locus start+j);
  - local background substitution rate over a centered 51 bp window
    (cSNPBkgndRateWindow, KAligner.h:42) floored at cMinSeqErrRate=0.005 and
    gated at cMaxBkgdNoiseThres=0.20;
  - per-locus P-value  = P(X >= NumNonRef) under Binomial(TotBases, rate)
    (reference computes 1 - CStats::Binomial(n, k, p) where Binomial is the
    CDF, libkit4b/Stats.cpp:543 — including its n>5000 clamp quirk, which we
    reproduce for output equivalence);
  - Benjamini-Hochberg: sort ascending by P, accept while
    P < (rank/k) * QValue (KAligner.cpp:7613-7624).

Pileup accumulation is vectorized np.bincount over flattened
(locus * 5 + base) keys — a host-side segment-sum; the device path (psum over
shards) arrives with multi-host streaming.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.stats import binom

from .. import dna
from ..io.fasta import Genome

BASE_COLS = 5  # A C G T N


@dataclass
class SnpOptions:
    min_snp_reads: int = 5         # cDfltMinSNPreads (-p MinSNPreads)
    qvalue: float = 0.05           # cDfltQValueSNP
    max_bkgd_noise: float = 0.20   # cMaxBkgdNoiseThres
    min_seq_err: float = 0.005     # cMinSeqErrRate
    bkgd_window: int = 51          # cSNPBkgndRateWindow
    non_ref_pcnt: float = 25.0     # SNPNonRefPcnt (KAlignerCL.cpp:922)
    snp_id_prefix: str = "SNP"


def ref_binomial_cdf(n: int, k: int, p: float) -> float:
    """CStats::Binomial equivalent (libkit4b/Stats.cpp:543-563): CDF
    P(X <= k), with the reference's n>5000 clamp (k scaled by 1000/n)."""
    if k > n:
        return 0.0
    if n > 5000:
        k = int((1000.0 / n) * k)
        n = 5000
    return float(min(binom.cdf(k, n, p), 1.0))


@dataclass
class SnpCall:
    chrom: str
    loci: int          # 0-based within chrom
    ref_base: int
    counts: np.ndarray  # [5] A C G T N
    tot_bases: int
    non_ref: int
    bkgd_rate: float
    pvalue: float
    rank: int = 0
    marker_id: int = 0          # marker fasta id when marker reporting ran
    num_polymorphic: int = 0    # polymorphic sites within the marker


class SnpCaller:
    """Accumulate pileups batch-by-batch, then call SNPs genome-wide."""

    def __init__(self, genome: Genome, options: SnpOptions | None = None):
        self.genome = genome
        self.opt = options or SnpOptions()
        G = len(genome.seq)
        self._counts = np.zeros(G * BASE_COLS, dtype=np.uint32)

    def add_alignments(self, pos: np.ndarray, oriented_reads: np.ndarray
                       ) -> None:
        """pos [N] concatenated-genome start positions; oriented_reads [N, L]
        uint8 codes as aligned to the forward genome ('-' hits already
        reverse-complemented)."""
        if len(pos) == 0:
            return
        N, L = oriented_reads.shape
        loci = pos[:, None].astype(np.int64) + np.arange(L, dtype=np.int64)
        base = np.minimum(oriented_reads, dna.BASE_N).astype(np.int64)
        keys = (loci * BASE_COLS + base).ravel()
        # accumulate over the covered key span only, and add in place
        # without materialising a genome-sized int64 copy
        kmin = int(keys.min())
        kmax = int(keys.max())
        bc = np.bincount(keys - kmin, minlength=kmax - kmin + 1)
        np.add(self._counts[kmin:kmax + 1], bc,
               out=self._counts[kmin:kmax + 1], casting="unsafe")

    # --- calling ------------------------------------------------------------
    def call(self) -> list[SnpCall]:
        opt = self.opt
        g = self.genome
        G = len(g.seq)
        counts = self._counts.reshape(G, BASE_COLS)
        acgt = counts[:, :4]
        tot = acgt.sum(axis=1).astype(np.int64)

        ref = g.seq.astype(np.int64)
        valid_ref = ref < 4
        ref_cnt = np.where(valid_ref,
                           acgt[np.arange(G), np.minimum(ref, 3)], 0)
        non_ref = tot - ref_cnt

        # global substitution rate floor (KAligner.cpp:7320: per-chrom in the
        # reference; genome-wide here)
        tot_nr = int(non_ref.sum())
        tot_all = int(tot.sum())
        global_rate = max(opt.min_seq_err, tot_nr / max(1, tot_all))

        # local background substitution rate over centered window, excluding
        # the candidate site's own counts (KAligner.cpp:7430-7445 LocTMM/LocTM)
        w = opt.bkgd_window
        half = w // 2
        csum_nr = np.concatenate([[0], np.cumsum(non_ref)])
        csum_tot = np.concatenate([[0], np.cumsum(tot)])
        lo = np.maximum(0, np.arange(G) - half)
        hi = np.minimum(G, np.arange(G) + half + 1)
        win_nr = (csum_nr[hi] - csum_nr[lo]) - non_ref
        win_tot = (csum_tot[hi] - csum_tot[lo]) - tot
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = np.where(win_tot > 0, win_nr / np.maximum(win_tot, 1),
                            global_rate)
        rate = np.maximum(rate, global_rate)

        # candidate gates (KAligner.cpp:7401-7445): coverage, >=1 non-ref,
        # non-ref proportion >= SNPNonRefPcnt, background below noise cap
        with np.errstate(divide="ignore", invalid="ignore"):
            prop = np.where(tot > 0, non_ref / np.maximum(tot, 1), 0.0)
        cand = (valid_ref & (tot >= opt.min_snp_reads) & (non_ref >= 1)
                & (prop >= opt.non_ref_pcnt / 100.0)
                & (rate <= opt.max_bkgd_noise))
        idxs = np.nonzero(cand)[0]

        calls: list[SnpCall] = []
        chrom_idx, chrom_off = g.locate(idxs) if len(idxs) else (None, None)
        for j, i in enumerate(idxs):
            p = 1.0 - ref_binomial_cdf(int(tot[i]), int(non_ref[i]),
                                       float(rate[i]))
            calls.append(SnpCall(
                chrom=g.names[int(chrom_idx[j])], loci=int(chrom_off[j]),
                ref_base=int(ref[i]), counts=counts[i].copy(),
                tot_bases=int(tot[i]), non_ref=int(non_ref[i]),
                bkgd_rate=float(rate[i]), pvalue=p))

        # Benjamini-Hochberg (KAligner.cpp:7613-7624): ascending P, accept
        # while P < (rank/k)*QValue, then re-sort by loci.
        calls.sort(key=lambda c: c.pvalue)
        k = len(calls)
        accepted: list[SnpCall] = []
        for rank, c in enumerate(calls, start=1):
            if c.pvalue >= (rank / k) * opt.qvalue:
                break
            c.rank = rank
            accepted.append(c)
        accepted.sort(key=lambda c: (c.chrom, c.loci))
        return accepted

    def coverage(self) -> np.ndarray:
        """Total ACGT coverage per concatenated-genome position."""
        return self._counts.reshape(-1, BASE_COLS)[:, :4].sum(
            axis=1).astype(np.uint32)


_BASE_CHR = "ACGTN"


def write_snps_csv(path, calls: list[SnpCall], experiment: str = "exp") -> None:
    """CSV report, column layout following the reference's SNP CSV
    (KAligner.cpp OutputSNPs CSV branch, simplified to the core columns)."""
    with open(path, "w") as f:
        f.write('"SNP_ID","ElType","Species","Chrom","StartLoci","EndLoci",'
                '"Len","Strand","Rank","PValue","Bases","Mismatches",'
                '"RefBase","MMBaseA","MMBaseC","MMBaseG","MMBaseT","MMBaseN",'
                '"BackgroundSubRate","MarkerID","NumPolymorphicSites"\n')
        for sid, c in enumerate(calls, start=1):
            cnts = c.counts.copy()
            cnts[c.ref_base] = 0
            f.write(f'{sid},"SNP","{experiment}","{c.chrom}",{c.loci},'
                    f'{c.loci},1,"+",{c.rank},{c.pvalue:.6g},{c.tot_bases},'
                    f'{c.non_ref},"{_BASE_CHR[c.ref_base]}",{cnts[0]},'
                    f'{cnts[1]},{cnts[2]},{cnts[3]},{cnts[4]},'
                    f'{c.bkgd_rate:.6g},{c.marker_id},'
                    f'{c.num_polymorphic}\n')


def write_snps_vcf(path, calls: list[SnpCall],
                   source: str = "kit4b_tpu_kalign") -> None:
    """VCF 4.1 output (reference emits VCF4.1 from release 1.11.0,
    KAligner.cpp OutputSNPs VCF branch)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        f.write(f"##source={source}\n")
        f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Total '
                'Depth">\n')
        f.write('##INFO=<ID=AF,Number=A,Type=Float,Description="Allele '
                'Frequency">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for sid, c in enumerate(calls, start=1):
            alts = [(int(c.counts[b]), b) for b in range(4)
                    if b != c.ref_base and c.counts[b] > 0]
            alts.sort(reverse=True)
            alt_str = ",".join(_BASE_CHR[b] for _, b in alts) or "."
            af = ",".join(f"{cnt / max(c.tot_bases, 1):.4f}"
                          for cnt, _ in alts) or "0"
            qual = min(999, int(-10 * np.log10(max(c.pvalue, 1e-100))))
            f.write(f"{c.chrom}\t{c.loci + 1}\t{c.chrom}_{c.loci + 1}\t"
                    f"{_BASE_CHR[c.ref_base]}\t{alt_str}\t{qual}\tPASS\t"
                    f"DP={c.tot_bases};AF={af}\n")
