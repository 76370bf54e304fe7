"""Haplotype grouping over sample PBAs (CCallHaplotypes modes 3-6, 10).

The port's copy of kit4b_tpu/kmer/haplogroups.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Parity with the reference's haplotype-grouping half of
ngskit4b/CallHaplotypes.cpp:

- per-bin all-vs-all founder difference matrices with affine-gap
  handling and consensus imputation of uncovered loci
  (GenHaplotypeGroups, :9423-9607); mode 4 scores coverage-level
  differences (|a-b| > 10) instead of allele inequality
- greedy centroid clustering with a binary search over the centroid
  distance to satisfy the max-groups constraint
  (GroupHaplotypes, :9262-9420)
- multi-phase refinement: later phases impute uncovered loci from the
  current group consensus until membership stabilises
- mode 5: differential group targets (DGTs) — loci where a non-noise
  group's major allele segregates, accepted on a log2-scaled
  precision/recall F-measure (GenBinDGTs, :8328-8560)
- mode 6: grouping centroid distances to WIG
- mode 10: group-segregating K-mers with a minimum inter-group Hamming
  (GenBinKMers, :8802-9150)

All inner loops are vectorized numpy over [F, L] PBA byte matrices —
the reference's per-locus pointer walks become one [F, F, chunk]
broadcast per bin.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .pba import unpack_pba


@dataclass
class HaploGroups:
    chrom: str
    start: int
    num_loci: int
    centroid_distance: int
    groups: list            # list of np.ndarray of member sample indices
    phases_run: int = 1


def consensus_pba(pbas: np.ndarray) -> np.ndarray:
    """Per-locus modal PBA byte over samples (GenConsensusPBA)."""
    F, L = pbas.shape
    # vectorized mode: one-hot over 256 byte values is wasteful; use
    # sort-based mode per column in chunks
    out = np.empty(L, np.uint8)
    chunk = 1 << 18
    for o in range(0, L, chunk):
        seg = np.sort(pbas[:, o:o + chunk], axis=0)
        # modal run per column: boundaries of equal runs
        n = seg.shape[1]
        best = seg[0].copy()
        best_run = np.ones(n, np.int32)
        run = np.ones(n, np.int32)
        for i in range(1, F):
            same = seg[i] == seg[i - 1]
            run = np.where(same, run + 1, 1)
            upd = run > best_run
            best_run = np.where(upd, run, best_run)
            best = np.where(upd, seg[i], best)
        out[o:o + chunk] = best
    return out


def diff_matrix(pbas: np.ndarray, *, coverage_mode: bool = False,
                affine_gap_len: int = 3,
                impute: np.ndarray | None = None) -> np.ndarray:
    """All-vs-all difference counts [F, F] over a bin's PBAs
    (GenHaplotypeGroups inner loops). impute: per-locus fallback byte
    substituted where a sample has no coverage (0); None leaves gaps to
    the affine-gap scoring: runs of relative gaps score only their
    first affine_gap_len loci (affine_gap_len<0 scores full gaps,
    0 leaves gaps unscored)."""
    F, L = pbas.shape
    diffs = np.zeros((F, F), np.int64)
    chunk = max(1, (1 << 22) // max(F * F, 1))
    for o in range(0, L, chunk):
        seg = pbas[:, o:o + chunk]
        if impute is not None:
            cons = impute[o:o + chunk]
            seg = np.where(seg == 0, cons[None, :], seg)
        a = seg[:, None, :]
        b = seg[None, :, :]
        if coverage_mode:
            d = (np.abs(a.astype(np.int16) - b.astype(np.int16)) > 10)
        else:
            d = a != b
        gap = (a == 0) | (b == 0)
        if impute is not None:
            # consensus substitution already filled gaps
            diffs += d.sum(axis=2)
            continue
        if affine_gap_len == 0:
            diffs += (d & ~gap).sum(axis=2)
        elif affine_gap_len < 0:
            diffs += d.sum(axis=2)
        else:
            # score only the first affine_gap_len loci of each gap run
            grun = np.zeros(gap.shape[:2], np.int32)
            acc = np.zeros(gap.shape[:2], np.int64)
            for i in range(seg.shape[1]):
                gi = gap[:, :, i]
                grun = np.where(gi, grun + 1, 0)
                score = d[:, :, i] & (~gi | (grun <= affine_gap_len))
                acc += score
            diffs += acc
    return diffs


def group_at_distance(diffs: np.ndarray, dist: int) -> list[np.ndarray]:
    """Greedy max-coverage clustering at a centroid distance
    (GroupHaplotypes inner do-loop): repeatedly pick the row covering
    the most unassigned samples within `dist` (ties: lowest diff sum)."""
    F = diffs.shape[0]
    unassigned = np.ones(F, bool)
    groups = []
    while unassigned.any():
        within = (diffs <= dist) & unassigned[None, :]
        sizes = within.sum(axis=1)
        sums = np.where(within, diffs, 0).sum(axis=1)
        order = np.lexsort((sums, -sizes))
        row = order[0]
        members = np.nonzero(within[row])[0]
        if len(members) == 0:
            members = np.nonzero(unassigned)[0][:1]
        groups.append(members)
        unassigned[members] = False
    return groups


def group_haplotypes(diffs: np.ndarray, *, min_dist: int = 5,
                     max_dist: int = 10_000, max_groups: int = 5
                     ) -> tuple[list, int]:
    """Binary-search the centroid distance in [min_dist, max_dist] for
    the smallest distance yielding <= max_groups groups
    (GroupHaplotypes binary search)."""
    lo, hi = min_dist, max_dist
    best, best_d, best_n = None, None, 0
    if min_dist == max_dist:
        return group_at_distance(diffs, min_dist), min_dist
    while hi >= lo:
        mid = (lo + hi) // 2
        groups = group_at_distance(diffs, mid)
        if len(groups) > max_groups:
            lo = mid + 1
        else:
            if len(groups) >= best_n:
                best, best_d, best_n = groups, mid, len(groups)
            hi = mid - 1
    if best is None:
        best = group_at_distance(diffs, max_dist)
        best_d = max_dist
    return best, best_d


def gen_haplotype_groups(pbas: np.ndarray, chrom: str, start: int, *,
                         coverage_mode: bool = False,
                         affine_gap_len: int = 3, min_dist: int = 5,
                         max_dist: int | None = None,
                         max_groups: int = 5,
                         phases: int = 10) -> HaploGroups:
    """Multi-phase per-bin grouping (GenHaplotypeGroups): phase 0
    imputes uncovered loci from the all-sample consensus; later phases
    impute from the current group consensus, iterating until group
    membership stabilises."""
    F, L = pbas.shape
    if max_dist is None:
        max_dist = max(L - 1, min_dist + 1)
    cons = consensus_pba(pbas)
    prev_key = None
    groups, dist = [], min_dist
    for phase in range(max(phases, 1)):
        if phase == 0:
            impute = cons
        else:
            # group-consensus imputation for uncovered loci
            imp = np.zeros((F, L), np.uint8)
            for mem in groups:
                gc = consensus_pba(pbas[mem]) if len(mem) > 1 \
                    else pbas[mem[0]]
                imp[mem] = gc[None, :]
            filled = np.where(pbas == 0, imp, pbas)
            # gaps were group-consensus imputed; score every locus
            diffs = diff_matrix(filled, coverage_mode=coverage_mode,
                                affine_gap_len=-1)
            groups, dist = group_haplotypes(
                diffs, min_dist=min_dist, max_dist=max_dist,
                max_groups=max_groups)
            key = tuple(tuple(m.tolist()) for m in groups)
            if key == prev_key:
                return HaploGroups(chrom, start, L, dist, groups,
                                   phase + 1)
            prev_key = key
            continue
        diffs = diff_matrix(pbas, coverage_mode=coverage_mode,
                            affine_gap_len=affine_gap_len, impute=impute)
        groups, dist = group_haplotypes(diffs, min_dist=min_dist,
                                        max_dist=max_dist,
                                        max_groups=max_groups)
        prev_key = tuple(tuple(m.tolist()) for m in groups)
    return HaploGroups(chrom, start, L, dist, groups, phases)


@dataclass
class DGTLocus:
    chrom: str
    loci: int
    group_alleles: dict      # allele char -> (group idx, fmeasure)


def bin_dgts(groups: HaploGroups, pbas: np.ndarray, *,
             min_members: int = 10, min_prop: float = 0.10,
             min_fmeasure: float = 0.90, fbeta: float = 1.0,
             max_report: int = 0) -> list[DGTLocus]:
    """Mode 5: differential group targets. Per locus and non-noise
    group, the group-specific allele is accepted when its F-measure
    (recall = carriers/members; precision = log2-scaled group share of
    all carriers) reaches min_fmeasure (GenBinDGTs:8480-8556)."""
    F, L = pbas.shape
    glist = groups.groups[:5]
    n_members = np.asarray([len(m) for m in glist])
    noise = (n_members < min_members) | \
        (n_members / F < min_prop)
    if (~noise).sum() < 2 or n_members.max() < min_members:
        return []
    max_members = n_members[~noise].max()
    scales = np.where(noise, 1.0, np.log2(1.0 + max_members
                                          / np.maximum(n_members, 1)))
    # per-sample allele presence [F, L, 4]
    out: list[DGTLocus] = []
    fb2 = fbeta * fbeta
    chunk = 1 << 16
    bases = "ACGT"
    for o in range(0, L, chunk):
        seg = pbas[:, o:o + chunk]
        has = np.stack([(seg >> 6) & 3, (seg >> 4) & 3,
                        (seg >> 2) & 3, seg & 3], axis=2) > 0  # [F,l,4]
        grp_cnt = np.stack([has[m].sum(axis=0) for m in glist])  # [G,l,4]
        all_cnt = grp_cnt.sum(axis=0)                            # [l,4]
        scaled = grp_cnt * scales[:, None, None]
        sum_scaled = scaled.sum(axis=0)                          # [l,4]
        recall = grp_cnt / np.maximum(n_members[:, None, None], 1)
        precision = np.where(sum_scaled[None] >= 1.0,
                             scaled / np.maximum(sum_scaled[None], 1e-12),
                             0.0)
        denom = fb2 * precision + recall
        fm = np.where(denom > 0,
                      (1 + fb2) * precision * recall / np.maximum(
                          denom, 1e-12), 0.0)
        fm = np.where(noise[:, None, None], 0.0, fm)
        fm = np.where((all_cnt[None] == 0) | (grp_cnt == 0), 0.0, fm)
        ok = fm >= min_fmeasure                                  # [G,l,4]
        loci_any = ok.any(axis=(0, 2))
        for li in np.nonzero(loci_any)[0]:
            ga = {}
            for ai in range(4):
                gi = np.nonzero(ok[:, li, ai])[0]
                if len(gi):
                    ga[bases[ai]] = (int(gi[0]), float(fm[gi[0], li, ai]))
            out.append(DGTLocus(groups.chrom, groups.start + o + int(li),
                                ga))
            if max_report and len(out) >= max_report:
                return out
    return out


def write_dgts_csv(path, dgts: list[DGTLocus]) -> None:
    with open(path, "w") as f:
        f.write('"RowID","Chrom","Loci","Allele","Group","FMeasure"\n')
        n = 0
        for d in dgts:
            for allele, (grp, fm) in sorted(d.group_alleles.items()):
                n += 1
                f.write(f'{n},"{d.chrom}",{d.loci},"{allele}",'
                        f'{grp + 1},{fm:.4f}\n')


def groupings_to_wig(path, bins: list[HaploGroups], *,
                     track: str = "hapgrps") -> None:
    """Mode 6: per-bin centroid distances as a WIG track
    (eMCSHGrpDist2WIG)."""
    with open(path, "w") as f:
        f.write(f'track type=wiggle_0 name="{track}"\n')
        cur = None
        for hg in bins:
            if hg.chrom != cur:
                cur = hg.chrom
                f.write(f"variableStep chrom={hg.chrom} "
                        f"span={hg.num_loci}\n")
            f.write(f"{hg.start + 1} {hg.centroid_distance}\n")


def group_kmers(groups: HaploGroups, pbas: np.ndarray, *,
                kmer_size: int = 25, min_hamming: int = 2,
                max_nocov: int = 0, min_members: int = 10,
                min_prop: float = 0.10) -> list[dict]:
    """Mode 10: K-mers of group-consensus PBAs where every inter-group
    pair differs by at least min_hamming (GenBinKMers). Returns
    [{loci, hammings, consensi}]."""
    glist = [m for m in groups.groups[:5]]
    n_members = np.asarray([len(m) for m in glist])
    F = pbas.shape[0]
    keep = [i for i, n in enumerate(n_members)
            if n >= min_members and n / F >= min_prop]
    if len(keep) < 2:
        return []
    consensi = np.stack([consensus_pba(pbas[glist[i]])
                         if len(glist[i]) > 1 else pbas[glist[i][0]]
                         for i in keep])                     # [G, L]
    G, L = consensi.shape
    out = []
    if L < kmer_size:
        return out
    # sliding window pairwise hamming via cumulative diffs
    diff = consensi[:, None, :] != consensi[None, :, :]      # [G,G,L]
    nocov = (consensi == 0)
    anynocov = nocov[:, None, :] | nocov[None, :, :]
    cd = np.concatenate([np.zeros((G, G, 1), np.int64),
                         np.cumsum(diff, axis=2)], axis=2)
    cn = np.concatenate([np.zeros((G, G, 1), np.int64),
                         np.cumsum(anynocov, axis=2)], axis=2)
    for o in range(L - kmer_size + 1):
        h = cd[:, :, o + kmer_size] - cd[:, :, o]
        nc = cn[:, :, o + kmer_size] - cn[:, :, o]
        iu = np.triu_indices(G, 1)
        if (nc[iu] > max_nocov).any():
            continue
        if (h[iu] >= min_hamming).all():
            out.append({"loci": groups.start + o,
                        "min_hamming": int(h[iu].min()),
                        "max_hamming": int(h[iu].max())})
    return out


def report_groups_csv(path, bins: list[HaploGroups],
                      sample_names: list[str]) -> None:
    """ReportHaplotypeGroups-style CSV: one row per (bin, group) with
    member sample list."""
    with open(path, "w") as f:
        f.write('"Chrom","StartLoci","NumLoci","CentroidDistance",'
                '"Group","NumMembers","Members"\n')
        for hg in bins:
            for gi, mem in enumerate(hg.groups):
                names = ";".join(sample_names[i] for i in mem)
                f.write(f'"{hg.chrom}",{hg.start},{hg.num_loci},'
                        f'{hg.centroid_distance},{gi + 1},{len(mem)},'
                        f'"{names}"\n')
