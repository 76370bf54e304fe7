"""callhaplotypes: founder/progeny skim-read haplotype calling from PBAs.

The port's copy of kit4b_tpu/kmer/callhaplotypes.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Capability parity with the core of CCallHaplotypes (ngskit4b/
CallHaplotypes.cpp — the reference's largest engine): progeny PBAs are
scored against founder PBAs per genomic bin; each bin is called to the
founder whose alleles the progeny's alleles are consistent with, `Fa x Fb`
heterozygous when both match, or uncalled. Alleles "match" when the allele
sets intersect (progeny skim coverage gives low scores; any shared allele
counts, exclusive founder support discriminates).

Smoothing follows the reference's two mechanisms
(CCallHaplotypes::ImputeProgenyHeterozygosity CallHaplotypes.cpp:2233-2236
and ImputeOutliersHaplotypes): a Wald-Wolfowitz runs test over each
call's proximal window decides whether rapid Fa/Fb switching is random
sampling of an underlying heterozygous region (random -> impute Fa x Fb),
run at the full proximal window then again at window/5; isolated outlier
calls flanked by agreeing neighbours are then flipped. The runs-test
critical values are computed from the exact run-count distribution
rather than the reference's precomputed table (CStats::
IsRandomHaplotypesFaFb, libkit4b/Stats.cpp:577, Stats.h:49-51) — same
decision at P>=0.025, any n.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from .pba import load_pba_any, unpack_pba

CALL_NONE = "none"
CALL_HET = "FaFb"


@dataclass
class BinCall:
    chrom: str
    start: int
    end: int
    call: str            # founder name, "FaFb", or "none"
    support: dict        # founder -> exclusive-consistent locus count
    n_loci: int


def _informative(fa_sc: np.ndarray, fb_sc: np.ndarray) -> np.ndarray:
    """Loci where the two founders have disjoint allele sets (these are the
    discriminating markers)."""
    fa_has = fa_sc > 0
    fb_has = fb_sc > 0
    return ((fa_has & fb_has).sum(axis=1) == 0) & fa_has.any(axis=1) \
        & fb_has.any(axis=1)


def call_haplotypes(progeny_pba_path, founder_paths: dict, *,
                    bin_size: int = 10_000, min_loci: int = 5,
                    het_ratio: float = 0.25, smooth: bool = True,
                    ww_prox_window: int = 1_000_000,
                    return_raw: bool = False):
    """F-founder haplotype calling (round 5 lifts the two-founder
    restriction — the reference accepts up to cMaxFounderReadsets=2000
    founder readsets, ngskit4b/CallHaplotypes.h:9). founder_paths:
    {name: pba path}, two or more entries.

    Per bin, each founder scores the loci where the progeny's alleles
    are consistent with IT ALONE (exclusive support). A locus is
    informative when >=2 founders carry alleles there and the founders
    with alleles are pairwise allele-disjoint (at F=2 this reduces
    exactly to the previous disjoint-allele-set rule); a progeny
    matching >=2 founders at such a locus is genuine heterozygosity
    evidence. The bin calls to the top founder, to the top PAIR when
    shared evidence dominates or the runner-up holds >= het_ratio of
    the exclusive support, or uncalled. Two-founder outputs are
    bit-identical to the previous implementation.

    return_raw=True additionally returns the pre-smoothing calls (the
    reference's mode-1 'raw' matrix, CallHaplotypes.cpp:2218-2232)."""
    names = list(founder_paths)
    F = len(names)
    if F < 2:
        raise ValueError("callhaplotypes needs at least two founders")
    _, prog = load_pba_any(progeny_pba_path)
    fmaps = [load_pba_any(p)[1] for p in founder_paths.values()]

    calls: list[BinCall] = []
    for chrom, p_pba in prog.items():
        if any(chrom not in fm for fm in fmaps):
            continue
        n = min(len(p_pba), *(len(fm[chrom]) for fm in fmaps))
        psc = unpack_pba(p_pba[:n])
        fmats = [unpack_pba(fm[chrom][:n]) for fm in fmaps]
        f_has_col = np.stack([f > 0 for f in fmats])        # [F, n, 4]
        # informative: founders with alleles are pairwise disjoint
        # (every allele column held by at most one founder) and >= 2
        # founders present
        disjoint = (f_has_col.sum(axis=0) <= 1).all(axis=1)
        present_cnt = f_has_col.any(axis=2).sum(axis=0)
        p_has = psc > 0
        covered = p_has.any(axis=1)
        matched = np.stack([(p_has & (f > 0)).any(axis=1)
                            for f in fmats])                # [F, n]
        m_cnt = matched.sum(axis=0)
        info = disjoint & (present_cnt >= 2) & covered
        excl = matched & (m_cnt == 1)[None, :] & info[None, :]
        shared = info & (m_cnt >= 2)

        edges = np.arange(0, n, bin_size)
        excl_b = np.add.reduceat(excl.astype(np.int64), edges, axis=1)
        shared_b = np.add.reduceat(shared.astype(np.int64), edges)
        info_b = np.add.reduceat(info.astype(np.int64), edges)
        for bi, start in enumerate(edges.tolist()):
            end = min(start + bin_size, n)
            e = excl_b[:, bi]
            sh = int(shared_b[bi])
            n_loci = int(info_b[bi])
            # top founder; ties resolve to the LATER founder (the
            # two-founder code called fb on a_excl == b_excl)
            top = F - 1 - int(np.argmax(e[::-1]))
            rest = np.delete(np.arange(F), top)
            second = int(rest[len(rest) - 1
                              - int(np.argmax(e[rest][::-1]))])
            support = {names[f]: int(e[f]) for f in range(F)}
            total = int(e.sum()) + sh
            if n_loci < min_loci or total == 0:
                call = CALL_NONE
            elif sh / total >= 0.5:
                call = CALL_HET if F == 2 \
                    else f"{names[top]}x{names[second]}"
            else:
                e1, e2 = int(e[top]), int(e[second])
                minor = e2 / max(1, e1 + e2)
                if minor >= het_ratio:
                    call = CALL_HET if F == 2 \
                        else f"{names[top]}x{names[second]}"
                else:
                    call = names[top]
            calls.append(BinCall(chrom, start, end, call, support,
                                 n_loci))

    raw = list(calls)
    if smooth:
        founders = tuple(names)
        if ww_prox_window > 0:
            # reference runs the WW impute twice: full window, then /5
            # to catch outliers (CallHaplotypes.cpp:2233-2236)
            calls = impute_heterozygosity(calls, founders,
                                          ww_prox_window)
            calls = impute_heterozygosity(calls, founders,
                                          ww_prox_window // 5)
        calls = impute_outliers(calls, ww_prox_window or 1_000_000)
    if return_raw:
        return raw, calls
    return calls


def _runs_cdf(n1: int, n2: int, r: int) -> float:
    """Exact P(R <= r) for the number of runs in a random arrangement of
    n1 + n2 binary labels (the Wald-Wolfowitz runs distribution)."""
    total = math.comb(n1 + n2, n1)
    acc = 0
    for rr in range(2, r + 1):
        k = rr // 2
        if rr % 2 == 0:
            acc += 2 * math.comb(n1 - 1, k - 1) * math.comb(n2 - 1, k - 1)
        else:
            acc += (math.comb(n1 - 1, k - 1) * math.comb(n2 - 1, k)
                    + math.comb(n1 - 1, k) * math.comb(n2 - 1, k - 1))
    return acc / total


@lru_cache(maxsize=None)
def runs_crit_value(n1: int, n2: int, alpha: float = 0.025) -> int:
    """Too-few-runs critical value: one less than the smallest run count
    r with P(R <= r) >= alpha. Computed exactly; reproduces every entry
    of the reference's precomputed table (Stats.h:51
    WaldWolfowitzRunsCritValues, verified 361/361). r <= crit rejects
    randomness; r > crit is random."""
    for r in range(2, n1 + n2 + 1):
        if _runs_cdf(n1, n2, r) >= alpha:
            return r - 1
    return n1 + n2


def is_random_haplotypes(n_fa: int, n_fb: int, runs: int) -> bool:
    """CStats::IsRandomHaplotypesFaFb: True when the Fa/Fb switching
    pattern is consistent with random sampling of a heterozygous region
    (run count above the too-few-runs critical value). Domain clamps
    mirror the reference (n in 2..20, 1 < r <= n1+n2)."""
    if n_fa < 2 or n_fa > 20 or n_fb < 2 or n_fb > 20 \
            or runs <= 1 or runs > n_fa + n_fb:
        return False
    return runs > runs_crit_value(n_fa, n_fb)


def impute_heterozygosity(calls: list[BinCall], founders: tuple,
                          max_distance: int = 1_000_000) -> list[BinCall]:
    """ImputeProgenyHeterozygosity: for each called bin, examine the +-10
    neighbouring called bins within max_distance on the same chrom; count
    per-founder calls and runs (het bins add two runs, reference
    CallHaplotypes.cpp 'boost to randomness'); when >=3 runs over >=6
    calls switch randomly per the runs test, re-call the bin Fa x Fb.

    F > 2 founders (round 5): the runs test is binary, so each window
    tests the TWO founders with the most window calls; a window where a
    third founder is also called is not Fa/Fb-style random switching
    and is left alone. The imputed het pair is that window's top pair.
    Two-founder behaviour unchanged."""
    founders = tuple(founders)
    het_labels = {CALL_HET} | {f"{a}x{b}" for a in founders
                               for b in founders if a != b}
    out = list(calls)
    mark: dict[int, str] = {}
    for i, cur in enumerate(out):
        if cur.call == CALL_NONE:
            continue
        n = {f: 0 for f in founders}
        runs = seq_len = 0
        prev_hap = None
        lo, hi = max(0, i - 9), min(len(out) - 1, i + 10)
        for j in range(lo, hi + 1):
            chk = out[j]
            if chk.chrom != cur.chrom or chk.call == CALL_NONE:
                continue
            if abs(cur.start - chk.start) > max_distance:
                continue
            if chk.call in het_labels:
                # reference het branch (CallHaplotypes.cpp:2540-2551): two
                # sequential haplotypes boost runs AND both founder counts;
                # PrevHap is left unchanged
                runs += 2
                seq_len += 2
                if chk.call == CALL_HET:
                    pa, pb = founders[0], founders[1]
                else:
                    pa, pb = chk.call.split("x", 1)
                n[pa] = n.get(pa, 0) + 1
                n[pb] = n.get(pb, 0) + 1
                continue
            if chk.call not in n:
                continue
            if prev_hap is None or prev_hap != chk.call:
                runs += 1
            prev_hap = chk.call
            n[chk.call] += 1
            seq_len += 1
        counts = sorted(n.items(), key=lambda kv: -kv[1])
        (fa_name, na), (fb_name, nb) = counts[0], counts[1]
        third = sum(v for _, v in counts[2:])
        if third == 0 and runs >= 3 and seq_len >= 6 and \
                is_random_haplotypes(na, nb, runs):
            mark[i] = CALL_HET if len(founders) == 2 \
                else f"{fa_name}x{fb_name}"
    for i, label in mark.items():
        c = out[i]
        out[i] = BinCall(c.chrom, c.start, c.end, label,
                         c.support, c.n_loci)
    return out


def impute_outliers(calls: list[BinCall],
                    max_distance: int = 1_000_000) -> list[BinCall]:
    """ImputeOutliersHaplotypes: a single call differing from equal
    neighbouring calls within max_distance is flipped to match them."""
    out = list(calls)
    for i in range(1, len(out) - 1):
        prev, cur, nxt = out[i - 1], out[i], out[i + 1]
        if (prev.chrom == cur.chrom == nxt.chrom
                and prev.call == nxt.call != cur.call
                and prev.call != CALL_NONE
                and cur.call != CALL_NONE
                and cur.start - prev.start <= max_distance
                and nxt.start - cur.start <= max_distance):
            out[i] = BinCall(cur.chrom, cur.start, cur.end, prev.call,
                             cur.support, cur.n_loci)
    return out


def write_haplotype_matrix(path, per_progeny: dict[str, list[BinCall]],
                           founders: tuple) -> None:
    """ReportMatrix (CallHaplotypes.cpp:3277): rows chrom.loci (bins),
    columns progeny readsets; cell encodes the call: founder index+1
    (1=Fa, 2=Fb, ...), F+1 = heterozygous pair, 0 = uncalled (for two
    founders this is the reference's exact 0/1/2/3 coding)."""
    founders = tuple(founders)
    het_code = len(founders) + 1
    code = {CALL_NONE: 0, CALL_HET: het_code}
    for i, f in enumerate(founders):
        code[f] = i + 1
    names = list(per_progeny)
    keys = list(dict.fromkeys(
        (c.chrom, c.start) for calls in per_progeny.values() for c in calls))
    bymap = {n: {(c.chrom, c.start): c for c in per_progeny[n]}
             for n in names}
    with open(path, "w") as f:
        f.write('"Chrom","Loci"' + "".join(f',"{n}"' for n in names) + "\n")
        for chrom, start in keys:
            f.write(f'"{chrom}",{start}')
            for n in names:
                c = bymap[n].get((chrom, start))
                v = 0
                if c is not None:
                    # any "AxB" pair label codes as heterozygous
                    v = code.get(c.call,
                                 het_code if c.call != CALL_NONE
                                 and "x" in c.call else 0)
                f.write(f",{v}")
            f.write("\n")


def write_haplotypes_gwas(path, calls: list[BinCall],
                          founders: tuple) -> None:
    """ReportHaplotypesAsGWAS (CallHaplotypes.cpp:3072): 'CHR BP SNP P'
    rows for IGV viewing; P visually encodes the call — 0.3 Fa only,
    0.9 Fb only, 0.1 heterozygous (:3147-3156). Additional founders
    cycle through further track-distinct digits."""
    founders = tuple(founders)
    digits = (3, 9, 5, 7, 2, 8, 4, 6)
    pmap = {fname: digits[i % len(digits)]
            for i, fname in enumerate(founders)}
    with open(path, "w") as f:
        f.write("CHR BP SNP P\n")
        for c in calls:
            if c.call == CALL_NONE:
                continue
            if c.call in pmap:
                snp, p = c.call, pmap[c.call]
            else:
                snp = f"{founders[0]}:{founders[1]}" \
                    if c.call == CALL_HET else c.call.replace("x", ":")
                p = 1
            f.write(f"{c.chrom} {c.start} {snp} 0.{p}\n")


def write_haplotype_calls(path, calls: list[BinCall]) -> None:
    fnames = list(calls[0].support) if calls else ["A", "B"]
    with open(path, "w") as f:
        f.write('"Chrom","Start","End","Call",'
                + ",".join(f'"Support{n}"' for n in fnames)
                + ',"InformativeLoci"\n')
        for c in calls:
            sup = ",".join(str(c.support.get(n, 0)) for n in fnames)
            f.write(f'"{c.chrom}",{c.start},{c.end},"{c.call}",{sup},'
                    f'{c.n_loci}\n')
