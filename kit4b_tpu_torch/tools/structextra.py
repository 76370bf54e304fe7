"""Conformation-driven structure tools and site potentials, the port's copy
of kit4b_tpu/tools/structextra.py (host only; tests/test_torch_rehomed.py
holds it equal to the original statement for statement): predconfnucs
(dyads from minor groove and twist against a sliding baseline),
genstructprofile (three sampling modes), genstructstats, dnasitepotential
/ rnasitepotential, genelementseq, genelementprofiles, gencentroidmetrics
and proccentroids.
"""
from __future__ import annotations

import numpy as np

from .conformation import PROP_NAMES, struct_profile

NUC_FLANK = 73


def _groove_twist(codes: np.ndarray, params: dict):
    groove = struct_profile(codes, params["minorgroove"])
    twist = struct_profile(codes, params["twist"])
    # per-base values: step i covers bases i+3/i+4; pad to align per-base
    pad = np.full(3, np.nan, np.float32)
    groove = np.concatenate([pad, groove, np.full(4, np.nan, np.float32)])
    twist = np.concatenate([pad, twist, np.full(4, np.nan, np.float32)])
    return (np.nan_to_num(groove, nan=float(np.nanmean(groove))),
            np.nan_to_num(twist, nan=float(np.nanmean(twist))))


def _chk_grooves(groove: np.ndarray, twist: np.ndarray, pos: int):
    """13 decimer groove means (dyad at index 6) via twist accumulation
    (predconfnucs.cpp:1360-1430)."""
    chk = np.zeros(13, np.float64)
    chk[6] = groove[pos]
    # rightwards
    dec, acc, cnt, p = 7, 0.0, 0, pos
    total = 0.0
    while dec <= 12 and p + 1 < len(groove):
        p += 1
        acc += twist[p]
        phase = acc % 360.0
        if phase >= 330.0 or phase <= 30.0:
            total += groove[p]
            cnt += 1
        elif cnt > 0:
            chk[dec] = total / cnt
            dec, total, cnt = dec + 1, 0.0, 0
    # leftwards
    dec, acc, cnt, p = 5, 0.0, 0, pos
    total = 0.0
    while dec >= 0 and p - 1 >= 0:
        p -= 1
        acc += twist[p]
        phase = acc % 360.0
        if phase >= 330.0 or phase <= 30.0:
            total += groove[p]
            cnt += 1
        elif cnt > 0:
            chk[dec] = total / cnt
            dec, total, cnt = dec - 1, 0.0, 0
    return chk


def conf_dyad_scores(codes: np.ndarray, params: dict, *,
                     dyad_ratio: float = 1.020, dyad2_ratio: float = 1.015,
                     dyad3_ratio: float = 1.010,
                     baseline_win: int = 1250) -> np.ndarray:
    """Per-base dyad scores (0 where no qualifying dyad) for one
    sequence. baseline_win mirrors the reference's 5*WindLen sliding
    baseline (predconfnucs.cpp:1334)."""
    n = len(codes)
    scores = np.zeros(n, np.int32)
    if n < 2 * NUC_FLANK + 8:
        return scores
    groove, twist = _groove_twist(codes, params)
    win = min(baseline_win, n)
    csum = np.concatenate([[0.0], np.cumsum(groove)])
    half = win // 2
    centers = np.arange(n)
    lo = np.clip(centers - half, 0, n - win)
    baseline = (csum[lo + win] - csum[lo]) / win
    cand = np.where(groove / np.maximum(baseline, 1e-9) >= dyad_ratio)[0]
    cand = cand[(cand >= NUC_FLANK) & (cand < n - NUC_FLANK)]
    for pos in cand:
        b = baseline[pos]
        chk = _chk_grooves(groove, twist, int(pos))
        r1 = chk[6] / b
        r2 = (chk[5] + chk[7]) / (2 * b)
        r3 = (chk[:5].sum() + chk[8:].sum()) / (10 * b)
        if r2 < dyad2_ratio or r3 < dyad3_ratio:
            continue
        scores[pos] = int(1000 * ((r1 - 1.0) + (r2 - 1.0) * 0.85
                                  + (r3 - 1.0) * 0.75))
    return scores


def moving_average(x: np.ndarray, w: int) -> np.ndarray:
    if w <= 1:
        return x
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    half = w // 2
    n = len(x)
    lo = np.clip(np.arange(n) - half, 0, max(n - w, 0))
    return ((c[np.minimum(lo + w, n)] - c[lo]) /
            np.maximum(np.minimum(lo + w, n) - lo, 1))


def dyad_peaks(scores: np.ndarray) -> list[tuple]:
    """Group adjacent qualifying dyads (gap <= 1) and keep the local
    maximum (predconfnucs.cpp:7-8). Returns (first, last, peak, score)."""
    idx = np.where(scores > 0)[0]
    out = []
    if not len(idx):
        return out
    start = prev = int(idx[0])
    for i in idx[1:]:
        i = int(i)
        if i - prev <= 2:
            prev = i
        else:
            seg = scores[start:prev + 1]
            pk = start + int(np.argmax(seg))
            out.append((start, prev, pk, int(scores[pk])))
            start = prev = i
    seg = scores[start:prev + 1]
    pk = start + int(np.argmax(seg))
    out.append((start, prev, pk, int(scores[pk])))
    return out


def predconfnucs(genome, params: dict, *, dyad_ratio: float = 1.020,
                 dyad2_ratio: float = 1.015, dyad3_ratio: float = 1.010,
                 mov_avg: int = 10, baseline_win: int = 250,
                 include_bed=None) -> dict:
    """predconfnucs: per-chromosome dyad peak calls. Returns
    {chrom: [(first,last,peak,score)]}. baseline_win is the -A window
    (x5 as the reference's BaseLineWin = 5*WindLen)."""
    out = {}
    for ci, name in enumerate(genome.names):
        codes = genome.chrom_codes(ci)
        scores = conf_dyad_scores(
            np.asarray(codes), params, dyad_ratio=dyad_ratio,
            dyad2_ratio=dyad2_ratio, dyad3_ratio=dyad3_ratio,
            baseline_win=5 * max(baseline_win, 25))
        if mov_avg:
            sm = moving_average(scores.astype(np.float64), mov_avg)
            scores = np.where(scores > 0, np.maximum(sm, 1).astype(np.int32),
                              0)
        peaks = dyad_peaks(scores)
        if include_bed is not None:
            peaks = [p for p in peaks
                     if include_bed.overlapping(name, p[2] - 74, p[2] + 74)]
        out[name] = peaks
    return out


def write_predconfnucs(path, peaks: dict, fmt: int = 0,
                       track: str = "nucs") -> None:
    """Formats (predconfnucs.cpp -M): 0 bedGraph dyads, 1 BED dyads,
    2 CSV dyads, 3 bedGraph nucleosomes, 4 BED nucleosomes,
    5 CSV nucleosomes, 6 CSV scores."""
    with open(path, "w") as f:
        if fmt in (0, 3):
            f.write(f'track type=bedGraph name="{track}"\n')
        n = 0
        for chrom, lst in peaks.items():
            for first, last, peak, score in lst:
                n += 1
                if fmt == 0:
                    f.write(f"{chrom}\t{peak}\t{peak + 1}\t{score}\n")
                elif fmt == 1:
                    f.write(f"{chrom}\t{peak}\t{peak + 1}\tdyad{n}\t"
                            f"{min(score, 1000)}\t+\n")
                elif fmt == 2:
                    f.write(f'{n},"Dyad","{track}","{chrom}",{peak},'
                            f'{peak + 1},{score}\n')
                elif fmt == 3:
                    f.write(f"{chrom}\t{first - NUC_FLANK}\t"
                            f"{last + NUC_FLANK}\t{score}\n")
                elif fmt == 4:
                    f.write(f"{chrom}\t{first - NUC_FLANK}\t"
                            f"{last + NUC_FLANK}\tnuc{n}\t"
                            f"{min(score, 1000)}\t+\n")
                elif fmt == 5:
                    f.write(f'{n},"Nucleosome","{track}","{chrom}",'
                            f'{first - NUC_FLANK},{last + NUC_FLANK - 1},'
                            f'{146 + last - first},{score}\n')
                else:
                    f.write(f'"{chrom}",{peak},{score}\n')


def genstructprofile(records, params: dict, *, mode: int = 0,
                     n_samples: int = 0, trunc_len: int = 300,
                     ofs_start: int = 0, bkgnd_groove: float = 11.12,
                     dyad_ratio: float = 1.030, dyad2_ratio: float = 1.020,
                     dyad3_ratio: float = 1.015, seed: int = 1) -> list[dict]:
    """genstructprofile: dyad detection per fasta sequence against a
    fixed background groove (genstructprofile.cpp -b/-d/-D/-e). Modes:
    0 all, 1 first n, 2 random n sequences."""
    recs = list(records)
    if mode == 1 and n_samples:
        recs = recs[:n_samples]
    elif mode == 2 and n_samples and len(recs) > n_samples:
        rng = np.random.default_rng(seed)
        recs = [recs[i] for i in
                sorted(rng.choice(len(recs), n_samples, replace=False))]
    out = []
    for rec in recs:
        codes = np.asarray(rec.codes)[ofs_start:]
        if trunc_len and len(codes) > trunc_len:
            codes = codes[:trunc_len]
        if len(codes) < 2 * NUC_FLANK + 8:
            # short sequences: test the centre base only against the
            # fixed background
            groove, twist = _groove_twist(codes, params)
            pos = len(codes) // 2
            chk = _chk_grooves(groove, twist, pos)
            r1 = chk[6] / bkgnd_groove
            out.append({"name": rec.name, "n_dyads":
                        int(r1 >= dyad_ratio), "best_pos": pos,
                        "best_ratio": r1})
            continue
        groove, twist = _groove_twist(codes, params)
        n_dyads, best_pos, best_r = 0, -1, 0.0
        for pos in range(NUC_FLANK, len(codes) - NUC_FLANK):
            r1 = groove[pos] / bkgnd_groove
            if r1 < dyad_ratio:
                continue
            chk = _chk_grooves(groove, twist, pos)
            r2 = (chk[5] + chk[7]) / (2 * bkgnd_groove)
            r3 = (chk[:5].sum() + chk[8:].sum()) / (10 * bkgnd_groove)
            if r2 < dyad2_ratio or r3 < dyad3_ratio:
                continue
            n_dyads += 1
            if r1 > best_r:
                best_r, best_pos = r1, pos
        out.append({"name": rec.name, "n_dyads": n_dyads,
                    "best_pos": best_pos, "best_ratio": best_r})
    return out


def genstructstats(params: dict, out_path, *, sort_flank: bool = False
                   ) -> int:
    """genstructstats: report the loaded octamer parameter table as CSV
    (genstructstats.cpp); -s sorts by flanking-inwards base order."""
    props = [p for p in PROP_NAMES if p in params]
    idxs = np.arange(65536)
    if sort_flank:
        # sort by bases ordered outside-in: positions 0,7,1,6,2,5,3,4
        digits = np.stack([(idxs >> (2 * (7 - p))) & 3
                           for p in (0, 7, 1, 6, 2, 5, 3, 4)], axis=1)
        order = np.lexsort(digits.T[::-1])
    else:
        order = idxs
    bases = "ACGT"
    with open(out_path, "w") as f:
        f.write('"Octamer",' + ",".join(f'"{p}"' for p in props) + "\n")
        for i in order:
            mer = "".join(bases[(int(i) >> (2 * (7 - p))) & 3]
                          for p in range(8))
            f.write(f'"{mer}",' + ",".join(f"{params[p][i]:.4f}"
                                           for p in props) + "\n")
    return len(order)


# ------------------------------------------------------- site potentials

def site_potential(read_loci: list[dict], genome, *, strand: str = "*"
                   ) -> list[tuple]:
    """DNA/RNAseqSitePotential: octamer counts at read start sites
    (4nt 5' + 4nt 3' of the start; '-' strand reads use the read end)
    vs genome-wide octamer counts; per-octamer potential = site/genome
    (DNAseqSitePotential.cpp:597-706)."""
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    site = np.zeros(65536, np.int64)
    pow4 = (4 ** np.arange(7, -1, -1)).astype(np.int64)
    for e in read_loci:
        st = e.get("strand", "+")
        if strand != "*" and st != strand:
            continue
        if e["chrom"] not in starts:
            continue
        ofs = (e["end"] + 1 - 4) if st == "-" else (e["start"] - 4)
        if ofs < 0 or ofs + 8 >= lens[e["chrom"]]:
            continue
        sub = np.asarray(genome.seq[starts[e["chrom"]] + ofs:
                                    starts[e["chrom"]] + ofs + 8], np.int64)
        if (sub > 3).any():
            continue
        site[int(sub @ pow4)] += 1
    gen = np.zeros(65536, np.int64)
    for ci in range(len(genome.names)):
        c = np.asarray(genome.chrom_codes(ci), np.int64)
        if len(c) < 8:
            continue
        win = np.lib.stride_tricks.sliding_window_view(c, 8)
        ok = (win <= 3).all(axis=1)
        gen += np.bincount(win[ok] @ pow4, minlength=65536)
    out = []
    bases = "ACGT"
    for i in range(65536):
        if gen[i] == 0 and site[i] == 0:
            continue
        mer = "".join(bases[(i >> (2 * (7 - p))) & 3] for p in range(8))
        ratio = site[i] / gen[i] if gen[i] else 0.0
        out.append((mer, int(gen[i]), int(site[i]), ratio))
    return out


def write_site_potential(path, rows: list[tuple]) -> None:
    with open(path, "w") as f:
        for mer, g, s, r in rows:
            f.write(f'"{mer}",{g},{s},{r:.8f}\n')


# ------------------------------------------------------- element seq/profile

def genelementseq(loci: list[dict], genome, out_path, *, fmt: int = 0,
                  min_len: int = 0, max_len: int = 1_000_000,
                  classifier=None) -> int:
    """genelementseq: extract element sequences (genelementseq.cpp -p):
    0 extended CSV (with sequence + feature bits), 1 concatenated fasta,
    2 multifasta."""
    from .. import dna as _dna
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    rows = []
    for e in loci:
        if e["chrom"] not in starts or not (min_len <= e["len"] <= max_len):
            continue
        s0 = starts[e["chrom"]]
        a, b = max(0, e["start"]), min(lens[e["chrom"]], e["end"] + 1)
        codes = genome.seq[s0 + a:s0 + b]
        if e.get("strand", "+") == "-":
            codes = _dna.revcomp(codes)
        bits = classifier.feature_bits(e["chrom"], a, b - 1) \
            if classifier else e.get("features", 0)
        rows.append((e, _dna.decode(codes), bits))
    with open(out_path, "w") as f:
        if fmt == 0:
            f.write('"SrcID","Type","Species","Chrom","StartLoci",'
                    '"EndLoci","Len","Features","Seq"\n')
            for e, seq, bits in rows:
                f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                        f'"{e["chrom"]}",{e["start"]},{e["end"]},'
                        f'{e["len"]},{bits},"{seq}"\n')
        elif fmt == 1:
            f.write(">concatenated_elements\n")
            for e, seq, bits in rows:
                f.write(seq + "\n")
        else:
            for e, seq, bits in rows:
                f.write(f'>{e["type"]}{e["srcid"]} {e["chrom"]}:'
                        f'{e["start"]}-{e["end"]}\n{seq}\n')
    return len(rows)


def genelementprofiles(read_loci: list[dict], genes, *, num_bins: int = 100,
                       feature: int = 0, strand: int = 0,
                       flank_len: int = 1000,
                       profile: int = 0) -> dict:
    """genElementProfiles: bin read starts/density across gene bodies
    (feature 0), TSS (1) or TES (2) +/- flank (genElementProfiles.cpp
    -r/-n/-P). Returns {gene: int64[num_bins]} plus a summed profile."""
    want = {0: None, 1: "+", 2: "-"}[strand]
    per: dict[str, list] = {}
    for e in read_loci:
        if want and e.get("strand", "+") != want:
            continue
        per.setdefault(e["chrom"], []).append(
            (e["start"], e["end"], e.get("strand", "+")))
    for v in per.values():
        v.sort()
    out: dict[str, np.ndarray] = {}
    total = np.zeros(num_bins, np.int64)
    seen_starts: set = set()
    for g in genes:
        if feature == 0:
            span_s, span_e = g.start, g.end
        elif feature == 1:
            anchor = g.start if g.strand != "-" else g.end
            span_s, span_e = anchor - flank_len, anchor + flank_len
        else:
            anchor = g.end if g.strand != "-" else g.start
            span_s, span_e = anchor - flank_len, anchor + flank_len
        width = max(span_e - span_s, 1)
        prof = np.zeros(num_bins, np.int64)
        for (rs, re, st) in per.get(g.chrom, ()):
            if rs >= span_e or re < span_s:
                continue
            if profile == 2:
                key = (g.chrom, rs, st)
                if key in seen_starts:
                    continue
                seen_starts.add(key)
            if profile in (1, 2):
                anchor_pos = rs if st != "-" else re
                if not span_s <= anchor_pos < span_e:
                    continue
                b = (anchor_pos - span_s) * num_bins // width
                prof[min(b, num_bins - 1)] += 1
            else:
                b0 = max(rs, span_s)
                b1 = min(re + 1, span_e)
                lo = (b0 - span_s) * num_bins // width
                hi = (b1 - 1 - span_s) * num_bins // width
                prof[lo:hi + 1] += 1
        if g.strand == "-":
            prof = prof[::-1]
        out[g.name] = prof
        total += prof
    return {"genes": out, "total": total}


def write_element_profiles(path, res: dict) -> None:
    nb = len(res["total"])
    with open(path, "w") as f:
        f.write('"Feature",' + ",".join(f'"Bin{i + 1}"'
                                        for i in range(nb)) + "\n")
        f.write('"TOTAL",' + ",".join(str(int(v))
                                      for v in res["total"]) + "\n")
        for name, prof in res["genes"].items():
            f.write(f'"{name}",' + ",".join(str(int(v)) for v in prof)
                    + "\n")


# --------------------------------------------------------------- centroids

def gencentroidmetrics(malign, *, nmer: int = 5, mode: int = 0,
                       genome=None, overlap: bool = True) -> dict:
    """gencentroidmetrics: per-centroid-context counts. mode 1 counts
    N-mer occurrences across a genome; mode 0 counts aligned
    ref-vs-rel matches/mismatches per ref centroid N-mer context from a
    multialignment (gencentroidmetrics.cpp -m). The centroid is the
    middle base; context is the flanking N-mer."""
    assert nmer % 2 == 1
    pow4 = (4 ** np.arange(nmer - 1, -1, -1)).astype(np.int64)
    if mode == 1:
        cnt = np.zeros(4 ** nmer, np.int64)
        step = 1 if overlap else nmer
        for ci in range(len(genome.names)):
            c = np.asarray(genome.chrom_codes(ci), np.int64)
            if len(c) < nmer:
                continue
            win = np.lib.stride_tricks.sliding_window_view(c, nmer)[::step]
            ok = (win <= 3).all(axis=1)
            cnt += np.bincount(win[ok] @ pow4, minlength=4 ** nmer)
        return {"nmer": nmer, "counts": cnt}
    # alignment mode: matches/mismatches per ref context
    from .. import dna as _dna
    match = np.zeros(4 ** nmer, np.int64)
    mismatch = np.zeros(4 ** nmer, np.int64)
    half = nmer // 2
    for blk in malign.blocks:
        if len(blk.rows) < 2:
            continue
        ref, rel = np.asarray(blk.rows[0], np.int64), \
            np.asarray(blk.rows[1], np.int64)
        keep = (ref != _dna.BASE_INDEL)
        ref, rel = ref[keep], rel[keep]
        if len(ref) < nmer:
            continue
        win = np.lib.stride_tricks.sliding_window_view(ref, nmer)
        ok = (win <= 3).all(axis=1)
        ctx = win @ pow4
        centre_rel = rel[half:len(rel) - half]
        centre_ref = ref[half:len(ref) - half]
        is_match = (centre_rel == centre_ref) & ok
        is_mm = (centre_rel != centre_ref) & (centre_rel <= 3) & ok
        match += np.bincount(ctx[is_match], minlength=4 ** nmer)
        mismatch += np.bincount(ctx[is_mm], minlength=4 ** nmer)
    return {"nmer": nmer, "match": match, "mismatch": mismatch}


def write_centroid_metrics(path, res: dict) -> None:
    nmer = res["nmer"]
    bases = "ACGT"
    with open(path, "w") as f:
        if "counts" in res:
            f.write('"NMer","Count"\n')
            for i, v in enumerate(res["counts"]):
                if v == 0:
                    continue
                mer = "".join(bases[(i >> (2 * (nmer - 1 - p))) & 3]
                              for p in range(nmer))
                f.write(f'"{mer}",{int(v)}\n')
        else:
            f.write('"NMer","Matches","Mismatches"\n')
            for i in range(4 ** nmer):
                m, mm = int(res["match"][i]), int(res["mismatch"][i])
                if m == 0 and mm == 0:
                    continue
                mer = "".join(bases[(i >> (2 * (nmer - 1 - p))) & 3]
                              for p in range(nmer))
                f.write(f'"{mer}",{m},{mm}\n')


def proccentroids(in_path, out_path, *, nmer: int = 5, mode: int = 0
                  ) -> int:
    """proccentroids: derive stats from a centroid counts CSV
    (proccentroids.cpp -m): 0 genome count fractions, 1 alignment
    fix/mutation rates, 2 transitional probabilities per centroid base,
    3 stationary probabilities."""
    import csv as _csv
    rows = []
    with open(in_path, newline="") as f:
        for row in _csv.reader(f):
            if len(row) >= 2 and len(row[0].strip('"')) == nmer and \
                    all(c in "ACGT" for c in row[0].strip('"')):
                rows.append([row[0].strip('"')] +
                            [int(x) for x in row[1:] if x.strip()])
    half = nmer // 2
    with open(out_path, "w") as f:
        if mode == 0:
            tot = sum(r[1] for r in rows) or 1
            f.write('"NMer","Count","Fraction"\n')
            for r in rows:
                f.write(f'"{r[0]}",{r[1]},{r[1] / tot:.8f}\n')
        elif mode == 1:
            f.write('"NMer","Matches","Mismatches","MutationRate"\n')
            for r in rows:
                m = r[1]
                mm = r[2] if len(r) > 2 else 0
                rate = mm / (m + mm) if m + mm else 0.0
                f.write(f'"{r[0]}",{m},{mm},{rate:.8f}\n')
        elif mode == 2:
            # transitional probs: P(centroid base | flanking context)
            ctx: dict[str, np.ndarray] = {}
            for r in rows:
                c = r[0][:half] + r[0][half + 1:]
                ctx.setdefault(c, np.zeros(4, np.int64))
                ctx[c]["ACGT".index(r[0][half])] += r[1]
            f.write('"Context","pA","pC","pG","pT"\n')
            for c in sorted(ctx):
                v = ctx[c]
                tot = v.sum() or 1
                f.write(f'"{c}",' + ",".join(f"{x / tot:.6f}" for x in v)
                        + "\n")
        else:
            # stationary probabilities of the centroid base
            base_tot = np.zeros(4, np.int64)
            for r in rows:
                base_tot["ACGT".index(r[0][half])] += r[1]
            tot = base_tot.sum() or 1
            f.write('"Base","Stationary"\n')
            for i, b in enumerate("ACGT"):
                f.write(f'"{b}",{base_tot[i] / tot:.6f}\n')
    return len(rows)
