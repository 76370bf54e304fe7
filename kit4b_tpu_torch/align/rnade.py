"""rnade: RNA-seq differential transcript expression (CRNA_DE parity),
the port's copy of the engine of kit4b_tpu/align/rnade.py (float64
host numpy and scipy; the round-1 `differential_expression` surface of
the original, which `gendeseq` uses, is not part of it).

Full engine per ngskit4b/rnade.cpp: per-feature binned read coverage
(control vs experiment), Laplace-smoothed bin Pearson
(rnade.cpp Pearsons), Poisson-resampled confidence distributions of
Pearson / fold-change / chi-square PValue (rnade.cpp:4074-4180
PearsonsPValue), and the reference's classification lattice —
PearsonScore from {0.8, 0.5, 0.3} thresholds (rnade.h:56-59),
CntsScore from fold-median thresholds {1.25, 1.5, 1.75}
(rnade.h:61-64), DEscore = CntsScore*PearsonScore squashed onto 0..9
(rnade.cpp:4504-4518). Output columns mirror rnade.cpp:4326.

Input handling follows the reference: alignment loci from CSV loci /
BED / SAM, strand filtering, exclusion zones, a counts-coalescing
window (-c), an artifact per-loci count threshold (-a), library-size
auto-normalisation (rnade.cpp:2779-2800), and feature regions
(0 transcript, 1 exons, 2 introns, 3 CDS, 4 UTRs, 5 5'UTR, 6 3'UTR).

The bootstrap is one vectorized numpy pass (iters x bins Poisson
draws) instead of the reference's per-thread loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# classification thresholds (rnade.h:56-64)
HI_PEARSON, MOD_PEARSON, LO_PEARSON = 0.8, 0.5, 0.3
NO_FOLD, LO_FOLD, MOD_FOLD = 1.25, 1.50, 1.75
CLAMP_FOLD = 25.0

REGION_TRANSCRIPT = 0
REGION_EXONS = 1
REGION_INTRONS = 2
REGION_CDS = 3
REGION_UTRS = 4
REGION_5UTR = 5
REGION_3UTR = 6


@dataclass
class FeatDE:
    feature: str
    feat_len: int = 0
    n_exons: int = 0
    user_class: int = 1
    de_score: int = 0
    cnts_score: int = 0
    pearson_score: int = 0
    ctrl_unique_loci: int = 0
    expr_unique_loci: int = 0
    pvalue_median: float = 0.0
    pvalue_low95: float = 0.0
    pvalue_hi95: float = 0.0
    ctrl_cnts: int = 0
    expr_cnts: int = 0
    obs_fold: float = 0.0
    fold_median: float = 0.0
    fold_low95: float = 0.0
    fold_hi95: float = 0.0
    obs_pearson: float = 0.0
    pearson_median: float = 0.0
    pearson_low95: float = 0.0
    pearson_hi95: float = 0.0
    tot_bins: int = 0
    bins_shared: int = 0
    bins_ctrl_only: int = 0
    bins_expr_only: int = 0
    ctrl_bins: np.ndarray = field(default_factory=lambda: np.zeros(0))
    expr_bins: np.ndarray = field(default_factory=lambda: np.zeros(0))


def load_read_loci(paths, *, strand: int = 0, limit: int = 0,
                   exclude_zones: list | None = None) -> list[tuple]:
    """Read alignment start loci from SAM / BED / loci CSV files
    (rnade.cpp -t auto detection). Returns [(chrom, start, end, strand)].
    """
    out = []
    want = {0: None, 1: "+", 2: "-"}[strand]
    zones = {}
    for z in (exclude_zones or []):
        zones.setdefault(z["chrom"], []).append((z["start"], z["end"]))
    for path in (paths if isinstance(paths, (list, tuple)) else [paths]):
        p = str(path)
        head = open(p).read(512)
        if head.startswith("@") or ".sam" in p:
            from ..io.sam import read_sam
            for rec in read_sam(p):
                if not rec.is_mapped:
                    continue
                st = "-" if rec.is_reverse else "+"
                if want and st != want:
                    continue
                out.append((rec.rname, rec.pos - 1,
                            rec.pos - 1 + len(rec.seq), st))
                if limit and len(out) >= limit:
                    return out
        elif "\t" in head.splitlines()[0] if head else False:
            from ..io.bed import BedFile
            for ft in BedFile.load(p).features:
                if want and ft.strand != want:
                    continue
                out.append((ft.chrom, ft.start, ft.end, ft.strand or "+"))
        else:
            from ..tools.convert import read_loci_csv
            for e in read_loci_csv(p):
                if want and e.get("strand", "+") != want:
                    continue
                out.append((e["chrom"], e["start"], e["end"] + 1,
                            e.get("strand", "+")))
    if zones:
        out = [r for r in out
               if not any(s <= r[1] <= t for s, t in zones.get(r[0], ()))]
    return out


def _feature_spans(gene, region: int) -> list[tuple]:
    ex = list(zip((int(x) for x in gene.exon_starts),
                  (int(x) for x in gene.exon_ends)))
    if region == REGION_TRANSCRIPT:
        return [(gene.start, gene.end)]
    if region == REGION_EXONS:
        return ex
    if region == REGION_INTRONS:
        return [(ex[i][1], ex[i + 1][0]) for i in range(len(ex) - 1)
                if ex[i + 1][0] > ex[i][1]]
    cs, ce = gene.cds_start, gene.cds_end
    if region == REGION_CDS:
        return [(max(s, cs), min(e, ce)) for s, e in ex
                if min(e, ce) > max(s, cs)]
    utr5 = [(s, min(e, cs)) for s, e in ex if s < cs]
    utr3 = [(max(s, ce), e) for s, e in ex if e > ce]
    if gene.strand == "-":
        utr5, utr3 = utr3, utr5
    if region == REGION_5UTR:
        return utr5
    if region == REGION_3UTR:
        return utr3
    return utr5 + utr3   # REGION_UTRS


def _chi2_pvalue_1dof(chi: np.ndarray) -> np.ndarray:
    """P(Chi2_1 >= chi) = erfc(sqrt(chi/2)) (CStats::ChiSqr2PVal)."""
    from scipy.special import erfc  # type: ignore
    return erfc(np.sqrt(np.maximum(chi, 0.0) / 2.0))


def _chi2_2x2(a, b, c, d) -> np.ndarray:
    """Pearson chi-square of [[a,b],[c,d]] vectorized."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c = c.astype(np.float64)
    d = d.astype(np.float64)
    n = a + b + c + d
    num = (a * d - b * c)
    den = (a + b) * (c + d) * (a + c) * (b + d)
    return np.where(den > 0, n * num * num / np.maximum(den, 1e-300), 0.0)


try:
    from scipy.special import erfc as _erfc_available  # noqa: F401
    _HAVE_SCIPY = True
except Exception:                                       # pragma: no cover
    _HAVE_SCIPY = False


def _erfc(x: np.ndarray) -> np.ndarray:
    if _HAVE_SCIPY:
        from scipy.special import erfc
        return erfc(x)
    # Abramowitz-Stegun 7.1.26 fallback
    t = 1.0 / (1.0 + 0.3275911 * np.abs(x))
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    y = poly * np.exp(-x * x)
    return np.where(x >= 0, y, 2.0 - y)


def _laplace_pearson(c: np.ndarray, e: np.ndarray,
                     mask: np.ndarray) -> float:
    """Pearson over bins with coverage, +1 Laplace smoothing
    (rnade.cpp Pearsons)."""
    if not mask.any():
        return 0.0
    x = c[mask] + 1.0
    y = e[mask] + 1.0
    mx, my = x.mean(), y.mean()
    num = ((x - mx) * (y - my)).sum()
    den = math.sqrt(((x - mx) ** 2).sum() * ((y - my) ** 2).sum())
    return float(num / den) if den > 0 else 0.0


def _pearson_rows(c: np.ndarray, e: np.ndarray,
                  mask: np.ndarray) -> np.ndarray:
    """Row-wise Laplace Pearson for the bootstrap ([iters, bins])."""
    x = np.where(mask, c + 1.0, np.nan)
    y = np.where(mask, e + 1.0, np.nan)
    mx = np.nanmean(x, axis=1, keepdims=True)
    my = np.nanmean(y, axis=1, keepdims=True)
    xd = np.where(mask, x - mx, 0.0)
    yd = np.where(mask, y - my, 0.0)
    num = (xd * yd).sum(axis=1)
    den = np.sqrt((xd * xd).sum(axis=1) * (yd * yd).sum(axis=1))
    return np.where(den > 0, num / np.maximum(den, 1e-300), 0.0)


def classify(fold_median: float, pearson_median: float,
             scored: bool) -> tuple[int, int, int]:
    """(cnts_score, pearson_score, de_score) per rnade.cpp:4460-4518."""
    if not scored:
        return 0, 0, 0
    if pearson_median >= HI_PEARSON:
        ps = 4
    elif pearson_median >= MOD_PEARSON:
        ps = 3
    elif pearson_median >= LO_PEARSON:
        ps = 2
    else:
        ps = 1
    fm = min(abs(fold_median), CLAMP_FOLD)
    if fold_median >= 0.1:
        if 0 < fm < 1.0:
            fm = 1.0 / fm
        if fm <= NO_FOLD:
            cs = 4       # eDESNone: least differential -> lowest DE rank
        elif fm <= LO_FOLD:
            cs = 3
        elif fm <= MOD_FOLD:
            cs = 2
        else:
            cs = 1       # eDEHi
    else:
        cs = 1
    de = cs * ps
    # squash the product lattice {0..16} onto 0..9 (rnade.cpp:4505-4518)
    if de > 4:
        de -= 1
        if de > 5:
            de -= 1
            if de > 7:
                de -= 2
                if de > 8:
                    de -= 3
    return cs, ps, de


def rnade_process(ctrl_loci: list, expr_loci: list, genes, *,
                  num_bins: int = 10, region: int = REGION_EXONS,
                  min_feat_cnts: int = 10, min_start_loci: int = 5,
                  coalesce_win: int = 1, artifact_thres: int = 20,
                  norm_scale: float = 0.0, max_iters: int = 10_000,
                  feat_strand: int = 0, filt_nonaligned: bool = False,
                  seed: int = 1) -> list[FeatDE]:
    """Differential-expression pass over gene features (CRNA_DE::Process).
    genes: io.biobed.GeneModel list."""
    rng = np.random.default_rng(seed)
    want_fs = {0: None, 1: "+", 2: "-"}[feat_strand]

    def index_starts(loci):
        per: dict[str, list] = {}
        for chrom, s, e, st in loci:
            per.setdefault(chrom, []).append(s)
        return {c: np.sort(np.asarray(v, np.int64))
                for c, v in per.items()}

    ctrl_idx = index_starts(ctrl_loci)
    expr_idx = index_starts(expr_loci)
    n_ctrl, n_expr = max(len(ctrl_loci), 1), max(len(expr_loci), 1)
    # library-size normalisation (rnade.cpp:2779-2800): autoscale makes
    # experiment counts comparable to control
    if norm_scale == 0.0:
        expr_scale = n_ctrl / n_expr
    elif norm_scale > 0:
        expr_scale = norm_scale
    else:
        expr_scale = 1.0 / -norm_scale
    out: list[FeatDE] = []
    for g in genes:
        if want_fs and g.strand != want_fs:
            continue
        spans = [s for s in _feature_spans(g, region) if s[1] > s[0]]
        if not spans:
            continue
        feat_len = sum(e - s for s, e in spans)
        fd = FeatDE(g.name, feat_len, len(g.exon_starts),
                    tot_bins=num_bins)
        # concatenated feature coordinate -> genome loci mapping per span
        ctrl_cnt = np.zeros(num_bins, np.float64)
        expr_cnt = np.zeros(num_bins, np.float64)
        ctrl_loci_n = np.zeros(num_bins, np.int64)
        expr_loci_n = np.zeros(num_bins, np.int64)
        rel0 = 0
        for s, e in spans:
            for which, idx, cnts, locn, scale in (
                    (0, ctrl_idx, ctrl_cnt, ctrl_loci_n, 1.0),
                    (1, expr_idx, expr_cnt, expr_loci_n, expr_scale)):
                starts = idx.get(g.chrom)
                if starts is None:
                    continue
                lo = int(np.searchsorted(starts, s))
                hi = int(np.searchsorted(starts, e))
                if hi <= lo:
                    continue
                pos = starts[lo:hi]
                uniq, ucnt = np.unique(pos, return_counts=True)
                if coalesce_win > 1 and len(uniq) > 1:
                    # coalesce loci within the window onto the first
                    keep = np.ones(len(uniq), bool)
                    last = uniq[0]
                    for i in range(1, len(uniq)):
                        if uniq[i] - last < coalesce_win:
                            keep[i] = False
                            ucnt[np.nonzero(uniq == last)[0][0]] += ucnt[i]
                        else:
                            last = uniq[i]
                    uniq, ucnt = uniq[keep], ucnt[keep]
                if artifact_thres:
                    ucnt = np.minimum(ucnt, artifact_thres)
                rel = rel0 + (uniq - s)
                b = np.minimum(rel * num_bins // max(feat_len, 1),
                               num_bins - 1)
                np.add.at(cnts, b, ucnt * scale)
                np.add.at(locn, b, 1)
            rel0 += e - s
        fd.ctrl_cnts = int(round(ctrl_cnt.sum()))
        fd.expr_cnts = int(round(expr_cnt.sum()))
        fd.ctrl_unique_loci = int(ctrl_loci_n.sum())
        fd.expr_unique_loci = int(expr_loci_n.sum())
        fd.ctrl_bins = ctrl_cnt
        fd.expr_bins = expr_cnt
        mask = (ctrl_cnt > 0) | (expr_cnt > 0)
        fd.bins_shared = int(((ctrl_cnt > 0) & (expr_cnt > 0)).sum())
        fd.bins_ctrl_only = int(((ctrl_cnt > 0) & (expr_cnt == 0)).sum())
        fd.bins_expr_only = int(((expr_cnt > 0) & (ctrl_cnt == 0)).sum())
        scored = ((fd.ctrl_cnts >= min_feat_cnts
                   or fd.expr_cnts >= min_feat_cnts)
                  and (fd.ctrl_unique_loci >= min_start_loci
                       or fd.expr_unique_loci >= min_start_loci)
                  and mask.any())
        if scored:
            fd.obs_pearson = _laplace_pearson(ctrl_cnt, expr_cnt, mask)
            fd.obs_fold = (fd.expr_cnts / fd.ctrl_cnts
                           if fd.ctrl_cnts >= 1
                           else fd.expr_cnts * 1.0001)
            iters = min(max_iters, num_bins * 2000)
            # vectorized Poisson bootstrap (PearsonsPValue)
            cb = rng.poisson(np.broadcast_to(ctrl_cnt, (iters, num_bins)))
            eb = rng.poisson(np.broadcast_to(expr_cnt, (iters, num_bins)))
            m2 = np.broadcast_to(mask, (iters, num_bins))
            pearsons = _pearson_rows(cb, eb, m2)
            sum_c = cb.sum(axis=1)
            sum_e = eb.sum(axis=1)
            folds = np.where(sum_c >= 1, sum_e / np.maximum(sum_c, 1),
                             sum_e / 0.75)
            lib_c = rng.poisson(max(n_ctrl - fd.ctrl_cnts, 1), iters)
            lib_e = rng.poisson(max(int(n_expr * expr_scale)
                                    - fd.expr_cnts, 1), iters)
            lib_c = np.maximum(lib_c, sum_c)
            lib_e = np.maximum(lib_e, sum_e)
            chi = _chi2_2x2(lib_c, sum_c, lib_e, sum_e)
            pvals = _erfc(np.sqrt(np.maximum(chi, 0.0) / 2.0))
            fd.pearson_median = float(np.median(pearsons))
            fd.pearson_low95 = float(np.percentile(pearsons, 2.5))
            fd.pearson_hi95 = float(np.percentile(pearsons, 97.5))
            fd.fold_median = float(np.median(folds))
            fd.fold_low95 = float(np.percentile(folds, 2.5))
            fd.fold_hi95 = float(np.percentile(folds, 97.5))
            fd.pvalue_median = float(np.median(pvals))
            fd.pvalue_low95 = float(np.percentile(pvals, 2.5))
            fd.pvalue_hi95 = float(np.percentile(pvals, 97.5))
        fd.cnts_score, fd.pearson_score, fd.de_score = classify(
            fd.fold_median, fd.pearson_median, scored)
        if filt_nonaligned and fd.ctrl_cnts == 0 and fd.expr_cnts == 0:
            continue
        out.append(fd)
    return out


def write_rnade_csv(path, feats: list[FeatDE]) -> None:
    """Stats CSV with the reference's column set (rnade.cpp:4326)."""
    with open(path, "w") as f:
        f.write('"Classification","Feat","FeatLen","Exons","Score",'
                '"DECntsScore","PearsonScore","CtrlUniqueLoci",'
                '"ExprUniqueLoci","CtrlExprLociRatio","PValueMedian",'
                '"PValueLow95","PValueHi95","TotCtrlCnts","TotExprCnts",'
                '"TotCtrlExprCnts","ObsFoldChange","FoldMedian",'
                '"FoldLow95","FoldHi95","ObsPearson","PearsonMedian",'
                '"PearsonLow95","PearsonHi95"\n')
        for d in feats:
            ratio = (d.ctrl_unique_loci / d.expr_unique_loci
                     if d.expr_unique_loci else 0.0)
            f.write(f'{d.user_class},"{d.feature}",{d.feat_len},'
                    f'{d.n_exons},{d.de_score},{d.cnts_score},'
                    f'{d.pearson_score},{d.ctrl_unique_loci},'
                    f'{d.expr_unique_loci},{ratio:.4f},'
                    f'{d.pvalue_median:.6f},{d.pvalue_low95:.6f},'
                    f'{d.pvalue_hi95:.6f},{d.ctrl_cnts},{d.expr_cnts},'
                    f'{d.ctrl_cnts + d.expr_cnts},{d.obs_fold:.4f},'
                    f'{d.fold_median:.4f},{d.fold_low95:.4f},'
                    f'{d.fold_hi95:.4f},{d.obs_pearson:.4f},'
                    f'{d.pearson_median:.4f},{d.pearson_low95:.4f},'
                    f'{d.pearson_hi95:.4f}\n')


def write_bin_counts_csv(path, feats: list[FeatDE]) -> None:
    with open(path, "w") as f:
        if not feats:
            return
        nb = len(feats[0].ctrl_bins)
        hdr = ",".join(f'"CtrlBin{i + 1}"' for i in range(nb)) + "," + \
            ",".join(f'"ExprBin{i + 1}"' for i in range(nb))
        f.write('"Feat",' + hdr + "\n")
        for d in feats:
            f.write(f'"{d.feature}",'
                    + ",".join(str(int(v)) for v in d.ctrl_bins) + ","
                    + ",".join(str(int(v)) for v in d.expr_bins) + "\n")
