"""SNP calling from accepted alignments (kalign SNP phase), the port's
own copy of kit4b_tpu/align/snp.py: the caller and writers of `kalign -S`,
the DiSNP/TriSNP pass of `-X`, the centroid contexts of
`--snpcentroidfile` and the marker sequences of `--markerfile`.

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

import bisect
from collections import defaultdict
from dataclasses import dataclass
from itertools import combinations

import numpy as np
from scipy.stats import binom

from .. import dna
from ..io.fasta import Genome
from ..io.sam import read_sam

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


# --- DiSNP / TriSNP ---------------------------------------------------------

def call_multisnps(sam_path, calls: list[SnpCall], *, max_sep: int = 300,
                   order: int = 2, min_reads: int = 1):
    """Di/Tri-SNP haplotype counting (KAligner.cpp:10475
    IterateReadsOverlapping; cDfltMaxDiSNPSep=300, KAligner.h): for every
    pair (order=2) or triple (order=3) of accepted SNP loci within `max_sep`
    bp, count reads covering all loci per allele combination.

    Returns list of (chrom, loci_tuple, {allele_string: read_count}).
    Implemented as a second pass over the emitted SAM (the reference
    re-iterates its in-memory read store).
    """
    by_chrom: dict[str, list[int]] = defaultdict(list)
    for c in calls:
        by_chrom[c.chrom].append(c.loci)
    groups: list[tuple[str, tuple]] = []
    for chrom, loci in by_chrom.items():
        loci.sort()
        n = len(loci)
        for i in range(n):
            if order == 2:
                for j in range(i + 1, n):
                    if loci[j] - loci[i] > max_sep:
                        break
                    groups.append((chrom, (loci[i], loci[j])))
            else:
                for j in range(i + 1, n):
                    if loci[j] - loci[i] > max_sep:
                        break
                    for k in range(j + 1, n):
                        if loci[k] - loci[i] > max_sep:
                            break
                        groups.append((chrom, (loci[i], loci[j], loci[k])))
    gidx: dict[tuple, dict] = {g: defaultdict(int) for g in groups}
    loci_sorted = {chrom: sorted(l) for chrom, l in by_chrom.items()}

    for rec in read_sam(sam_path):
        if not rec.is_mapped:
            continue
        loci = loci_sorted.get(rec.rname)
        if not loci:
            continue
        start = rec.pos - 1
        end = start + len(rec.seq)
        lo = bisect.bisect_left(loci, start)
        hi = bisect.bisect_left(loci, end)
        cover = loci[lo:hi]
        if len(cover) < order:
            continue
        for t in _combos(cover, order):
            key = (rec.rname, t)
            if key in gidx:
                allele = "".join(rec.seq[x - start] for x in t)
                gidx[key][allele] += 1
    out = []
    for (chrom, loci), combos in gidx.items():
        total = sum(combos.values())
        if total >= min_reads and combos:
            out.append((chrom, loci, dict(combos)))
    return out


def _combos(items, order):
    return combinations(items, order)


def write_multisnps_csv(path, groups, order: int = 2) -> None:
    name = "DiSNP" if order == 2 else "TriSNP"
    with open(path, "w") as f:
        f.write(f'"{name}_ID","Chrom","Loci","Alleles","Counts"\n')
        for i, (chrom, loci, combos) in enumerate(groups, start=1):
            alleles = ";".join(sorted(combos))
            counts = ";".join(str(combos[a]) for a in sorted(combos))
            f.write(f'{i},"{chrom}","{"|".join(map(str, loci))}",'
                    f'"{alleles}","{counts}"\n')


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


# --- SNP centroid contexts (KAligner.cpp:7380-7397, :8100-8131, :8625) ------

CENTROID_FLANK = 3                      # cSNPCentfFlankLen
CENTROID_LEN = 2 * CENTROID_FLANK + 1   # 7-mer context
CENTROID_ELS = 4 ** CENTROID_LEN


def snp_centroids(caller: SnpCaller, accepted: list[SnpCall]) -> dict:
    """Centroid context distributions: for every 7-mer genome context
    (SNP site centered), NumInsts counts loci with calling-depth coverage
    (tot >= min_snp_reads, KAligner.cpp:7380-7397) and each accepted SNP
    adds its ref/non-ref pileup counts to its context's row (:8100-8131).

    Returns {"num_insts": [16384] int64, "num_snps": ..., "ref_cnt": ...,
    "base_cnts": [16384, 5]} with the reference's big-endian 7-mer index."""
    g = caller.genome
    G = len(g.seq)
    cov = caller._counts.reshape(G, BASE_COLS)[:, :4].sum(axis=1)
    seq = g.seq.astype(np.int64)
    # big-endian 7-mer value per center position (invalid where any flank
    # base is non-ACGT or crosses the chrom boundary sentinels)
    valid = seq < 4
    idx7 = np.zeros(G, np.int64)
    ok = np.ones(G, bool)
    for o in range(-CENTROID_FLANK, CENTROID_FLANK + 1):
        sh = np.roll(seq, -o)
        vv = np.roll(valid, -o)
        idx7 = (idx7 << 2) | np.where(vv, sh, 0)
        ok &= vv
    ok[:CENTROID_FLANK] = False
    ok[G - CENTROID_FLANK:] = False

    m = ok & (cov >= caller.opt.min_snp_reads)
    num_insts = np.bincount(idx7[m], minlength=CENTROID_ELS)

    num_snps = np.zeros(CENTROID_ELS, np.int64)
    ref_cnt = np.zeros(CENTROID_ELS, np.int64)
    base_cnts = np.zeros((CENTROID_ELS, 5), np.int64)
    for c in accepted:
        gpos = int(g.starts[g.names.index(c.chrom)]) + c.loci
        if not ok[gpos]:
            continue
        ci = int(idx7[gpos])
        num_snps[ci] += 1
        nr = c.counts.copy().astype(np.int64)
        ref_cnt[ci] += int(nr[c.ref_base])
        nr[c.ref_base] = 0
        base_cnts[ci] += nr
    return {"num_insts": num_insts, "num_snps": num_snps,
            "ref_cnt": ref_cnt, "base_cnts": base_cnts}


def write_snp_centroids_csv(path, cent: dict) -> None:
    """Reference centroid CSV layout (KAligner.cpp:8635-8650): one row per
    7-mer, CentroidID 1-based, central base as RefBase."""
    with open(path, "w") as f:
        f.write('"CentroidID","Seq","NumInsts","NumSNPs","RefBase",'
                '"RefBaseCnt","BaseA","BaseC","BaseG","BaseT","BaseN"\n')
        for i in range(CENTROID_ELS):
            v = i
            bases = []
            for _ in range(CENTROID_LEN):
                bases.append(v & 3)
                v >>= 2
            bases.reverse()
            seq = "".join(_BASE_CHR[b] for b in bases)
            bc = cent["base_cnts"][i]
            f.write(f'{i + 1},"{seq}",{cent["num_insts"][i]},'
                    f'{cent["num_snps"][i]},'
                    f'"{_BASE_CHR[bases[CENTROID_FLANK]]}",'
                    f'{cent["ref_cnt"][i]},{bc[0]},{bc[1]},{bc[2]},'
                    f'{bc[3]},{bc[4]}\n')


# --- marker sequence reporting (KAligner.cpp:7483-7565) ---------------------

def report_markers(path, caller: SnpCaller, accepted: list[SnpCall], *,
                   marker5_len: int = 25, marker3_len: int = 25,
                   poly_thres: float = 0.333) -> int:
    """Write marker fasta for accepted SNPs whose full flanking window has
    confident base calls (reference rules: every marker locus needs
    >= min_snp_reads coverage; loci with non-ref proportion <= poly_thres
    report the ref base, counting as polymorphic when > 0.1; otherwise a
    major allele with proportion >= 1 - poly_thres is required, counting
    as polymorphic when < 0.9; the SNP site itself needs non-ref
    proportion >= 0.5). Sets marker_id / num_polymorphic on the calls and
    returns the number of markers written.

    Descriptor layout: '>Marker<id> <chrom> <start>|<len>|<snploci>|
    <m5len>|<snpbase>|<refbase>|<numpoly>' (KAligner.cpp:7552)."""
    g = caller.genome
    G = len(g.seq)
    counts = caller._counts.reshape(G, BASE_COLS)
    seq = g.seq
    marker_len = 1 + marker5_len + marker3_len
    n = 0
    with open(path, "w") as f:
        for c in accepted:
            c.marker_id = 0
            c.num_polymorphic = 0
            ci = g.names.index(c.chrom)
            clen = int(g.lengths[ci])
            if c.loci < marker5_len or c.loci + marker3_len >= clen:
                continue
            if c.non_ref / max(c.tot_bases, 1) < 0.5:
                continue
            gpos = int(g.starts[ci]) + c.loci
            w = counts[gpos - marker5_len: gpos + marker3_len + 1]
            acgt = w[:, :4].astype(np.int64)
            tot = acgt.sum(axis=1)
            refb = seq[gpos - marker5_len: gpos + marker3_len + 1]
            if (tot < caller.opt.min_snp_reads).any() or (refb >= 4).any():
                continue
            ref_cnt = acgt[np.arange(marker_len), np.minimum(refb, 3)]
            nr_prop = (tot - ref_cnt) / tot
            mseq = []
            npoly = 0
            okm = True
            for i in range(marker_len):
                if nr_prop[i] <= poly_thres:
                    if nr_prop[i] > 0.1:
                        npoly += 1
                    mseq.append(_BASE_CHR[int(refb[i])])
                    continue
                nrc = acgt[i].copy()
                nrc[int(refb[i])] = 0
                props = nrc / tot[i]
                b = int(np.argmax(props))
                if props[b] >= 1.0 - poly_thres:
                    if props[b] < 0.9:
                        npoly += 1
                    mseq.append(_BASE_CHR[b])
                else:
                    okm = False
                    break
            if not okm:
                continue
            snp_base = mseq[marker5_len]
            ref_base = _BASE_CHR[int(refb[marker5_len])]
            if snp_base == ref_base:
                continue
            n += 1
            c.marker_id = n
            c.num_polymorphic = npoly
            f.write(f">Marker{n} {c.chrom} {c.loci - marker5_len}|"
                    f"{marker_len}|{c.loci}|{marker5_len}|{snp_base}|"
                    f"{ref_base}|{npoly}\n{''.join(mseq)}\n")
    return n
