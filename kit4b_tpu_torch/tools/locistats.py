"""Loci statistics, distributions and genome sampling, the port's copy of
kit4b_tpu/tools/locistats.py (host only; tests/test_torch_rehomed.py holds
it equal to the original statement for statement): loci2dist, gennucstats,
genloci2gene, gencomposition, genrollups, genseqcandidates and genzygosity
(exact and pigeonhole-seeded subsequence counts on a suffix index),
fastafilter and filterreads.
"""
from __future__ import annotations

import numpy as np

from .convert import read_loci_csv
from ..io.biobed import RegionClassifier

REGION_NAMES = ("IG", "US", "5'UTR", "CDS", "Intron", "3'UTR", "DS")

# length-range bin tables (genrollups.cpp:1192-1270); plain numeric
# configuration reproduced for interface parity
LEN_RANGES_FULL = [
    (0, 4), (5, 9), (10, 14), (15, 19), (20, 29), (30, 49), (50, 74),
    (75, 99), (100, 124), (125, 149), (150, 174), (175, 199), (200, 249),
    (250, 299), (300, 349), (350, 399), (400, 449), (450, 499), (500, 599),
    (600, 699), (700, 799), (800, 899), (900, 999), (1000, 1249),
    (1250, 1499), (1500, 1749), (1750, 1999), (2000, None)]
LEN_RANGES_REDUCED = [
    (0, 9), (10, 19), (20, 49), (50, 99), (100, 149), (150, 199),
    (200, 249), (250, 299), (300, None)]
LEN_RANGES_MINIMAL = [
    (0, 19), (20, 49), (50, 99), (100, 199), (200, 299), (300, None)]
LEN_RANGES_UCSC = [(200, None)]
RANGE_TABLES = {0: LEN_RANGES_FULL, 1: LEN_RANGES_REDUCED,
                2: LEN_RANGES_MINIMAL, 3: LEN_RANGES_UCSC}


def _range_label(rng) -> str:
    lo, hi = rng
    return f"{lo}-{hi}" if hi is not None else f"{lo}+"


def _range_idx(table, ln: int) -> int:
    for i, (lo, hi) in enumerate(table):
        if ln >= lo and (hi is None or ln <= hi):
            return i
    return len(table) - 1


# ----------------------------------------------------------------- loci2dist

def loci2dist(loci: list[dict], *, min_len: int = 1, max_len: int = 500,
              strand: int = 0, classifier: RegionClassifier | None = None
              ) -> dict:
    """loci2dist: per-length element counts, overall and (with a gene
    BED) per region (loci2dist.cpp -m/-s/-I)."""
    want = {0: None, 1: "+", 2: "-"}[strand]
    n_reg = len(REGION_NAMES)
    dist = np.zeros((max_len - min_len + 1, 1 + (n_reg if classifier else 0)),
                    np.int64)
    for e in loci:
        if want and e.get("strand", "+") != want:
            continue
        ln = e["len"]
        if ln < min_len or ln > max_len:
            continue
        dist[ln - min_len, 0] += 1
        if classifier:
            r = classifier.region_ordinal(e["chrom"], e["start"], e["end"])
            dist[ln - min_len, 1 + r] += 1
    return {"min_len": min_len, "dist": dist,
            "regions": REGION_NAMES if classifier else ()}


def write_loci2dist(path, res: dict) -> None:
    with open(path, "w") as f:
        cols = '"Len","Count"' + "".join(f',"{r}"' for r in res["regions"])
        f.write(cols + "\n")
        for i, row in enumerate(res["dist"]):
            if row[0] == 0:
                continue
            f.write(f'{res["min_len"] + i},' +
                    ",".join(str(int(v)) for v in row) + "\n")


# --------------------------------------------------------------- gennucstats

def gennucstats(background: list[dict], sample: list[dict] | None, *,
                bkg_dyad_ofs: int = 73, smpl_dyad_ofs: int = 73,
                wind_dyad: int = 5,
                classifier: RegionClassifier | None = None) -> dict:
    """gennucstats: derive dyad loci by offsetting element starts
    (nucleosome centre = start + 73), then either report the regional
    dyad distribution (mode 0) or score sample dyads against background
    dyads within +/- wind_dyad (mode 1) (gennucstats.cpp args)."""
    bk_per: dict[str, np.ndarray] = {}
    for e in background:
        bk_per.setdefault(e["chrom"], []).append(e["start"] + bkg_dyad_ofs)
    bk_per = {c: np.sort(np.asarray(v, np.int64)) for c, v in bk_per.items()}
    out: dict = {"n_background": sum(len(v) for v in bk_per.values())}
    if classifier:
        reg = np.zeros(len(REGION_NAMES), np.int64)
        for c, dyads in bk_per.items():
            for d in dyads:
                reg[classifier.region_ordinal(c, int(d), int(d))] += 1
        out["region_counts"] = {REGION_NAMES[i]: int(v)
                                for i, v in enumerate(reg)}
    if sample is not None:
        n_match = 0
        offsets = np.zeros(2 * wind_dyad + 1, np.int64)
        n_sample = 0
        for e in sample:
            d = e["start"] + smpl_dyad_ofs
            n_sample += 1
            b = bk_per.get(e["chrom"])
            if b is None or not len(b):
                continue
            i = int(np.searchsorted(b, d))
            best = None
            for j in (i - 1, i):
                if 0 <= j < len(b) and abs(int(b[j]) - d) <= wind_dyad:
                    o = int(b[j]) - d
                    if best is None or abs(o) < abs(best):
                        best = o
            if best is not None:
                n_match += 1
                offsets[best + wind_dyad] += 1
        out.update(n_sample=n_sample, n_matched=n_match,
                   offset_hist={o - wind_dyad: int(v)
                                for o, v in enumerate(offsets)})
    return out


# -------------------------------------------------------------- genloci2gene

def genloci2gene(loci: list[dict], classifier: RegionClassifier,
                 gene_bed, *, assoc_dist: int = 100000,
                 w_intergenic: int = 1, w_upstream: int = 4,
                 w_intragenic: int = 5, w_dnstream: int = 3,
                 clust_dist: int = 0, strand: int = 0) -> list[dict]:
    """genloci2gene: associate each locus (optionally clustered with
    neighbours within clust_dist) to its nearest gene within assoc_dist,
    weighted by relationship (genloci2gene.cpp -w/-x/-y/-z weights)."""
    want = {0: None, 1: "+", 2: "-"}[strand]
    rows = [e for e in loci if not want or e.get("strand", "+") == want]
    rows.sort(key=lambda e: (e["chrom"], e["start"]))
    # cluster
    clusters: list[list[dict]] = []
    for e in rows:
        if (clusters and clusters[-1][0]["chrom"] == e["chrom"]
                and e["start"] - clusters[-1][-1]["end"] <= clust_dist):
            clusters[-1].append(e)
        else:
            clusters.append([e])
    out = []
    for cl in clusters:
        chrom = cl[0]["chrom"]
        s, t = cl[0]["start"], max(e["end"] for e in cl)
        best = None
        for g in classifier.by_chrom.get(chrom, ()):
            if g.start - assoc_dist > t:
                break
            if g.end + assoc_dist <= s:
                continue
            if s < g.end and t >= g.start:
                w, rel, dist = w_intragenic, "intragenic", 0
            else:
                if t < g.start:
                    dist = g.start - t
                    before = True
                else:
                    dist = s - g.end + 1
                    before = False
                upstream = before if g.strand != "-" else not before
                w = w_upstream if upstream else w_dnstream
                rel = "upstream" if upstream else "downstream"
                if dist > assoc_dist:
                    continue
            score = w * 1000000 // (1 + dist)
            if best is None or score > best[0]:
                best = (score, g.name, rel, dist, w)
        if best is None:
            out.append({"chrom": chrom, "start": s, "end": t,
                        "n_loci": len(cl), "gene": "", "rel": "intergenic",
                        "dist": -1, "weight": w_intergenic})
        else:
            out.append({"chrom": chrom, "start": s, "end": t,
                        "n_loci": len(cl), "gene": best[1], "rel": best[2],
                        "dist": best[3], "weight": best[4]})
    return out


def write_loci2gene(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"Chrom","Start","End","NumLoci","Gene","Relationship",'
                '"Distance","Weight"\n')
        for e in rows:
            f.write(f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["n_loci"]},'
                    f'"{e["gene"]}","{e["rel"]}",{e["dist"]},'
                    f'{e["weight"]}\n')


# ------------------------------------------------------------ gencomposition

def gencomposition(loci: list[dict] | None, genome, *, per_seq: bool = False,
                   min_nmer: int = 1, max_nmer: int = 5, min_len: int = 10,
                   max_len: int = 1_000_000_000) -> dict:
    """gencomposition: N-mer composition over element loci sequences
    (whole chroms when no loci file given), modes 0 global / 1 per
    sequence (gencomposition.cpp)."""
    from .convert import quickcount
    from ..io.fasta import SeqRecord
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    recs = []
    if loci is None:
        for i, name in enumerate(genome.names):
            recs.append(SeqRecord(name, "", genome.chrom_codes(i)))
    else:
        for e in loci:
            if e["chrom"] not in starts or not \
                    (min_len <= e["len"] <= max_len):
                continue
            s0 = starts[e["chrom"]]
            a, b = max(0, e["start"]), min(lens[e["chrom"]], e["end"] + 1)
            recs.append(SeqRecord(f'{e["type"]}{e["srcid"]}', "",
                                  genome.seq[s0 + a:s0 + b]))
    return quickcount(recs, min_k=min_nmer, max_k=max_nmer, per_seq=per_seq)


# ---------------------------------------------------------------- genrollups

def genrollups(rows: list[dict], *, mode: int = 0, bin_class: int = 0,
               percentages: bool = False, region: int = 7,
               align2core: int = 1, pc_align2core: float = 0.0,
               id_align2core: float = 0.0, os_identity: float = 0.0
               ) -> list[dict]:
    """genrollups: roll hyperconserved element CSVs up into length-range
    bins (genrollups.cpp modes): 0 element totals, 1 regional totals,
    2 loci base totals, 3 regional base totals, 4 outspecies totals
    (elements passing the aligned-to-core thresholds)."""
    table = RANGE_TABLES.get(bin_class, LEN_RANGES_FULL)
    regional = mode in (1, 3)
    bases = mode in (2, 3)
    n_cols = len(REGION_NAMES) if regional else 1
    tot = np.zeros((len(table), n_cols), np.int64)
    for e in rows:
        ri = _range_idx(table, e["len"])
        col = 0
        if regional:
            bits = e.get("features", 0)
            col = _region_col(bits)
            if region != 7 and col != region:
                continue
        v = e["len"] if bases else 1
        if mode == 4:
            al = e.get("matches", 0) + e.get("mismatches", 0)
            if al < align2core:
                continue
            if pc_align2core > 0 and \
                    100.0 * al / max(e["len"], 1) < pc_align2core:
                continue
            if id_align2core > 0 and 100.0 * e.get("matches", 0) / \
                    max(e["len"], 1) < id_align2core:
                continue
            if os_identity > 0 and (al == 0 or 100.0 * e.get("matches", 0)
                                    / al < os_identity):
                continue
        tot[ri, col] += v
    out = []
    grand = tot.sum() or 1
    for i, rng in enumerate(table):
        row = {"range": _range_label(rng)}
        if regional:
            for j, rn in enumerate(REGION_NAMES):
                row[rn] = (100.0 * tot[i, j] / grand) if percentages \
                    else int(tot[i, j])
        else:
            row["total"] = (100.0 * tot[i, 0] / grand) if percentages \
                else int(tot[i, 0])
        out.append(row)
    return out


def _region_col(bits: int) -> int:
    if bits == 0:
        return 0
    for bit, col in ((0x01, 3), (0x02, 2), (0x04, 5), (0x08, 4),
                     (0x10, 1), (0x20, 6)):
        if bits & bit:
            return col
    return 0


def write_rollups(path, rows: list[dict]) -> None:
    if not rows:
        return
    cols = list(rows[0])
    with open(path, "w") as f:
        f.write(",".join(f'"{c}"' for c in cols) + "\n")
        for r in rows:
            f.write(",".join(f"{r[c]:.3f}" if isinstance(r[c], float)
                             else (f'"{r[c]}"' if isinstance(r[c], str)
                                   else str(r[c])) for c in cols) + "\n")


# ----------------------------------------------------------------- genomics

def _exact_entry_counts(index, sub: np.ndarray) -> np.ndarray:
    """Count exact matches of subsequence `sub` per genome entry using
    the LUT bucket + suffix verification; returns int64 [nchroms]."""
    g = index.genome
    k = index.lut_k
    cnt = np.zeros(len(g.names), np.int64)
    if len(sub) < k or (sub >= 4).any():
        return cnt
    key = 0
    for j in range(k):
        key = key * index.lut_base + int(sub[j])
    lo, hi = int(index.lut[key]), int(index.lut[key + 1])
    if hi <= lo:
        return cnt
    pos = np.asarray(index.sa_clean[lo:hi], np.int64)
    rest = len(sub) - k
    ok = pos + len(sub) <= len(g.seq)
    pos = pos[ok]
    if rest > 0 and len(pos):
        m = np.ones(len(pos), bool)
        for j in range(rest):
            m &= g.seq[pos + k + j] == sub[k + j]
        pos = pos[m]
    if len(pos):
        ci, _ = g.locate(pos)
        cnt += np.bincount(ci, minlength=len(g.names))
    return cnt


def genzygosity(index, *, subseq_len: int = 25, max_subs: int = 2,
                max_ns: int = 1, max_matches: int = 5000,
                threshold: float = 0.25, step: int | None = None) -> dict:
    """genzygosity: chrom x chrom zygosity matrix
    (genzygosity.cpp:745-760): tile each source entry into subsequences,
    count in which target entries each aligns, then
    zygosity[src][targ] = matches_in_targ / subseqs_of_src.

    Substitution tolerance uses pigeonhole seed probes: a subsequence is
    split into max_subs+1 segments; each segment is probed exactly and
    survivors verified host-side with <= max_subs mismatches."""
    g = index.genome
    n = len(g.names)
    step = step or subseq_len
    src_counts = np.zeros(n, np.int64)
    matrix = np.zeros((n, n), np.int64)
    nseg = max_subs + 1
    for ci in range(n):
        chrom = g.chrom_codes(ci)
        for ofs in range(0, len(chrom) - subseq_len + 1, step):
            sub = np.asarray(chrom[ofs:ofs + subseq_len])
            if int((sub >= 4).sum()) > max_ns:
                continue
            src_counts[ci] += 1
            if max_subs == 0:
                matrix[ci] += np.minimum(_exact_entry_counts(index, sub), 1)
                continue
            # pigeonhole: find candidate positions from exact segment hits
            hits = np.zeros(n, np.int64)
            cand: set[int] = set()
            seg_len = subseq_len // nseg
            for s in range(nseg):
                seg = sub[s * seg_len:(s + 1) * seg_len]
                if len(seg) < index.lut_k or (seg >= 4).any():
                    continue
                key = 0
                for j in range(index.lut_k):
                    key = key * index.lut_base + int(seg[j])
                lo, hi = int(index.lut[key]), int(index.lut[key + 1])
                if hi - lo > max_matches:
                    continue
                pos = np.asarray(index.sa_clean[lo:hi], np.int64)
                rest = len(seg) - index.lut_k
                if rest > 0 and len(pos):
                    m = pos + len(seg) <= len(g.seq)
                    pos = pos[m]
                    mm = np.ones(len(pos), bool)
                    for j in range(rest):
                        mm &= g.seq[pos + index.lut_k + j] == seg[j + index.lut_k]
                    pos = pos[mm]
                for p in pos:
                    cand.add(int(p) - s * seg_len)
            for p in cand:
                if p < 0 or p + subseq_len > len(g.seq):
                    continue
                window = g.seq[p:p + subseq_len]
                if int((window != sub).sum()) <= max_subs:
                    tci, _ = g.locate(np.asarray([p]))
                    hits[int(tci[0])] = 1
            matrix[ci] += hits
    zyg = matrix / np.maximum(src_counts[:, None], 1)
    return {"names": list(g.names), "src_counts": src_counts,
            "matrix": matrix, "zygosity": zyg, "threshold": threshold}


def write_zygosity(path, res: dict, raw_path=None) -> None:
    names = res["names"]
    with open(path, "w") as f:
        for i, src in enumerate(names):
            for j, targ in enumerate(names):
                z = res["zygosity"][i, j]
                if res["src_counts"][i] > 0 and z >= res["threshold"]:
                    f.write(f'"{src}",{int(res["src_counts"][i])},"{targ}",'
                            f'{int(res["matrix"][i, j])},{z:.6f}\n')
    if raw_path:
        with open(raw_path, "w") as f:
            for i, src in enumerate(names):
                for j, targ in enumerate(names):
                    f.write(f'"{src}",{int(res["src_counts"][i])},"{targ}",'
                            f'{int(res["matrix"][i, j])}\n')


def genseqcandidates(index, loci: list[dict], *, subseq_len: int = 25,
                     block_len: int = 1000, min_len: int = 147,
                     trunc_len: int = 147, ofs: int = 0,
                     delta_len: int = 0) -> list[dict]:
    """genseqcandidates: generate candidate blocks around regions of
    interest and count unique vs multi-mapping subsequences in each
    block (genseqcandidates.cpp -s/-b)."""
    g = index.genome
    starts = {n: int(s) for n, s in zip(g.names, g.starts)}
    lens = {n: int(l) for n, l in zip(g.names, g.lengths)}
    out = []
    for e in loci:
        if e["chrom"] not in starts:
            continue
        s = max(0, e["start"] + ofs)
        t = e["end"] + ofs + delta_len
        if t - s + 1 < min_len:
            continue
        if trunc_len and t - s + 1 > trunc_len:
            t = s + trunc_len - 1
        centre = (s + t) // 2
        bs = max(0, centre - block_len // 2)
        be = min(lens[e["chrom"]], bs + block_len)
        s0 = starts[e["chrom"]]
        block = g.seq[s0 + bs:s0 + be]
        n_unique = n_multi = n_total = 0
        for o in range(0, len(block) - subseq_len + 1, subseq_len):
            sub = np.asarray(block[o:o + subseq_len])
            if (sub >= 4).any():
                continue
            n_total += 1
            c = int(_exact_entry_counts(index, sub).sum())
            if c == 1:
                n_unique += 1
            elif c > 1:
                n_multi += 1
        out.append({**e, "block_start": bs, "block_end": be - 1,
                    "n_subseqs": n_total, "n_unique": n_unique,
                    "n_multi": n_multi})
    return out


def write_seqcandidates(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","BlockStart","BlockEnd","NumSubseqs","NumUnique",'
                '"NumMulti"\n')
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'{e["block_start"]},{e["block_end"]},{e["n_subseqs"]},'
                    f'{e["n_unique"]},{e["n_multi"]}\n')


# ---------------------------------------------------------------- fasta/read

def fasta_filter(in_path, out_path, *, mode: int = 0, max_n_run: int = 10,
                 sep_unique: str = ".") -> dict:
    """fastafilter: mode 0 truncates runs of indeterminate 'N's to
    max_n_run and suffixes duplicate identifiers with sep_unique+n;
    mode 1 reverse complements every sequence (fastafilter.cpp)."""
    from ..io.fasta import SeqRecord, read_seqs, write_fasta
    from .. import dna as _dna
    seen: dict[str, int] = {}
    recs = []
    n_trunc = 0
    for rec in read_seqs(in_path):
        codes = np.asarray(rec.codes)
        name = rec.name
        if mode == 1:
            codes = _dna.revcomp(codes)
        else:
            isn = codes >= 4
            if isn.any() and max_n_run >= 0:
                # collapse runs longer than max_n_run
                keep = np.ones(len(codes), bool)
                run = 0
                for i, v in enumerate(isn):
                    run = run + 1 if v else 0
                    if run > max_n_run:
                        keep[i] = False
                        n_trunc += 1
                codes = codes[keep]
            if name in seen:
                seen[name] += 1
                name = f"{name}{sep_unique}{seen[name]}"
            else:
                seen[name] = 0
        recs.append(SeqRecord(name, rec.descr, codes))
    write_fasta(out_path, recs)
    return {"n_seqs": len(recs), "n_bases_trimmed": n_trunc}


def filter_reads_by_region(loci: list[dict],
                           classifier: RegionClassifier, *,
                           regions_in: str = "", strand: int = 0) -> tuple:
    """filterreads: split aligned-read loci into retained (overlapping
    any of the regions_in ordinals) and dropped sets
    (filterreads.cpp -r)."""
    from ..io.biobed import region_mask_from_ordinals
    mask = region_mask_from_ordinals(regions_in) if regions_in else 0
    want = {0: None, 1: "+", 2: "-"}[strand]
    kept, dropped = [], []
    for e in loci:
        if want and e.get("strand", "+") != want:
            dropped.append(e)
            continue
        bits = classifier.feature_bits(e["chrom"], e["start"], e["end"])
        ok = True
        if mask:
            ok = bool(bits & mask & 0xff) or (bits == 0 and (mask & 0x100))
        (kept if ok else dropped).append(e)
    return kept, dropped
