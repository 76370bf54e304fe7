"""Loci-CSV manipulation tools, the port's copy of
kit4b_tpu/tools/csvtools.py (host only; tests/test_torch_rehomed.py holds
it equal to the original statement for statement): csvfilter, csvmerge,
csv2feat, csv2stats, processcsvfiles and genhyperdropouts over the shared
loci and outspecies element CSV formats.

Loci CSV rows: SrcID, ElType, Species, Chrom, Start, End, Len[, Strand].
Outspecies CSV rows extend to 14 fields: ..., RelSpecies(8),
Features(9), Unaligned(10), Matches(11), Mismatches(12), InDels(13)[,
Score(14)].
"""
from __future__ import annotations

import csv as _csv
import re

import numpy as np

from .convert import read_loci_csv, write_loci_csv
from ..io.biobed import region_mask_from_ordinals


# ---------------------------------------------------------------- outspecies

def read_outspecies_csv(path) -> list[dict]:
    """Read 14-field outspecies/hyper CSV rows
    (ProcessCSVfiles.cpp:368-396 field order)."""
    out = []
    with open(path, newline="") as f:
        for row in _csv.reader(f):
            if len(row) < 13:
                continue
            try:
                srcid = int(row[0].strip('"'))
            except ValueError:
                continue   # header
            out.append({
                "srcid": srcid, "type": row[1].strip().strip('"'),
                "species": row[2].strip().strip('"'),
                "chrom": row[3].strip().strip('"'),
                "start": int(row[4]), "end": int(row[5]),
                "len": int(row[6]),
                "relspecies": row[7].strip().strip('"'),
                "features": int(row[8]), "unaligned": int(row[9]),
                "matches": int(row[10]), "mismatches": int(row[11]),
                "indels": int(row[12]),
                "score": int(row[13]) if len(row) > 13 else 0})
    return out


def write_outspecies_csv(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'"{e["relspecies"]}",{e["features"]},{e["unaligned"]},'
                    f'{e["matches"]},{e["mismatches"]},{e["indels"]},'
                    f'{e.get("score", 0)}\n')


# ----------------------------------------------------------------- csvfilter

def csv_filter(rows: list[dict], *, min_len: int = 0, max_len: int = 0,
               regions_in: str = "", regions_out: str = "",
               species_in: list | None = None,
               exclude_refids: set | None = None,
               include_refids: set | None = None,
               exclude_loci: list | None = None,
               include_loci: list | None = None,
               chrom_exclude: list | None = None,
               chrom_include: list | None = None,
               overlaps: bool = False, no_overlaps: bool = False,
               align2core: int = 0, pc_align2core: float = 0.0,
               id_ident2core: float = 0.0, os_identity: float = 0.0,
               select_n: int = 0, seed: int = 1) -> list[dict]:
    """csvfilter: ordered filter pipeline over loci/outspecies rows
    (csvfilter.cpp:1690-1860 filter state machine).

    Filters (each independently marks a row filtered-out): length range,
    RefID exclude-then-include files, loci exclude-then-include overlap
    files, chrom regexes (exclude priority), region bits, species,
    overlap/no-overlap against sibling rows, and in outspecies mode the
    aligned-to-core thresholds; finally optional random SelectN.
    """
    rin = region_mask_from_ordinals(regions_in) if regions_in else 0
    rout = region_mask_from_ordinals(regions_out) if regions_out else 0
    exc_pats = [re.compile(p) for p in (chrom_exclude or [])]
    inc_pats = [re.compile(p) for p in (chrom_include or [])]

    # overlap detection: sort per chrom, scan
    overlapped: set[int] = set()
    if overlaps or no_overlaps:
        per: dict[str, list[tuple]] = {}
        for i, e in enumerate(rows):
            per.setdefault(e["chrom"], []).append((e["start"], e["end"], i))
        for lst in per.values():
            lst.sort()
            hi = -1
            hi_i = -1
            for s, e, i in lst:
                if s <= hi:
                    overlapped.add(i)
                    overlapped.add(hi_i)
                if e > hi:
                    hi, hi_i = e, i
    inc_iv = _interval_index(include_loci) if include_loci else None
    exc_iv = _interval_index(exclude_loci) if exclude_loci else None

    out = []
    for i, e in enumerate(rows):
        if min_len and e["len"] < min_len:
            continue
        if max_len and e["len"] > max_len:
            continue
        if exclude_refids and e["srcid"] in exclude_refids:
            continue
        if include_refids is not None and e["srcid"] not in include_refids:
            continue
        if exc_iv and _hits(exc_iv, e):
            continue
        if inc_iv and not _hits(inc_iv, e):
            continue
        key = f'{e["species"]}.{e["chrom"]}'
        if exc_pats and any(p.search(key) for p in exc_pats):
            continue
        if inc_pats and not any(p.search(key) for p in inc_pats):
            continue
        if species_in and e["species"] not in species_in:
            continue
        region = e.get("features", 0)
        if rout:
            if (region == 0 and (rout & 0x100)) or (region & rout & 0xff):
                continue
        if rin:
            if region == 0:
                if not (rin & 0x100):
                    continue
            else:
                # exclusive: row's region must be exactly one included bit
                # (csvfilter.cpp:1804-1817)
                if not any((rin & m) and (region & 0x3f) == m
                           for m in (1, 2, 4, 8, 16, 32)):
                    continue
        if overlaps and i in overlapped:
            continue
        if no_overlaps and i not in overlapped:
            continue
        if "matches" in e:
            al = e["matches"] + e["mismatches"]
            if align2core and al < align2core:
                continue
            if pc_align2core > 0 and 100.0 * al / max(e["len"], 1) < pc_align2core:
                continue
            if id_ident2core > 0 and \
                    100.0 * e["matches"] / max(e["len"], 1) < id_ident2core:
                continue
            if os_identity > 0 and \
                    (al == 0 or 100.0 * e["matches"] / al < os_identity):
                continue
        out.append(e)
    if select_n and len(out) > select_n:
        rng = np.random.default_rng(seed)
        keep = sorted(rng.choice(len(out), select_n, replace=False))
        out = [out[k] for k in keep]
    return out


def _interval_index(files: list) -> dict:
    iv: dict[str, list] = {}
    for path in files:
        for e in read_loci_csv(path):
            iv.setdefault(e["chrom"], []).append((e["start"], e["end"]))
    return {c: sorted(v) for c, v in iv.items()}


def _hits(iv: dict, e: dict) -> bool:
    for s, t in iv.get(e["chrom"], ()):
        if s > e["end"]:
            return False
        if t >= e["start"]:
            return True
    return False


# ------------------------------------------------------------------ csvmerge

MERGE_INTERSECT = 0      # Ref & Rel
MERGE_REF_EXCLUSIVE = 1  # Ref & !Rel
MERGE_REL_EXCLUSIVE = 2  # !Ref & Rel
MERGE_UNION = 3          # Ref | Rel
MERGE_NEITHER = 4        # !(Ref | Rel)


def csv_merge(ref: list[dict], rel: list[dict], *, mode: int = MERGE_UNION,
              min_len: int = 4, max_len: int = 1_000_000,
              min_merge_len: int = 4, max_merge_len: int = 1_000_000,
              ref_extend: int = 0, rel_extend: int = 0,
              join_distance: int = 0, ref_species: str = "",
              rel_species: str = "", el_type: str = "el") -> list[dict]:
    """csvmerge: interval set algebra between ref and rel loci sets
    (csvmerge.cpp -p modes 0-4), flank extension and gap joining.

    mode 4 (Neither) yields gaps between union elements per chromosome
    (bounded by the union's own extent, as the reference has no genome
    lengths available)."""
    def collect(rows, extend):
        per: dict[str, list] = {}
        for e in rows:
            if e["len"] < min_len or e["len"] > max_len:
                continue
            s = max(0, e["start"] - extend)
            t = e["end"] + extend
            per.setdefault(e["chrom"], []).append((s, t))
        return per

    ref_iv = _merge_intervals(collect(ref, ref_extend), 0)
    rel_iv = _merge_intervals(collect(rel, rel_extend), 0)
    chroms = sorted(set(ref_iv) | set(rel_iv))
    out_iv: dict[str, list] = {}
    for c in chroms:
        a, b = ref_iv.get(c, []), rel_iv.get(c, [])
        if mode == MERGE_INTERSECT:
            res = _iv_intersect(a, b)
        elif mode == MERGE_REF_EXCLUSIVE:
            res = _iv_subtract(a, b)
        elif mode == MERGE_REL_EXCLUSIVE:
            res = _iv_subtract(b, a)
        elif mode == MERGE_UNION:
            res = _iv_union(a, b)
        else:   # NEITHER: gaps within the union's span
            u = _iv_union(a, b)
            res = []
            for i in range(len(u) - 1):
                gs, ge = u[i][1] + 1, u[i + 1][0] - 1
                if ge >= gs:
                    res.append((gs, ge))
        out_iv[c] = res
    # gap joining + output length filter
    out = []
    srcid = 1
    for c in chroms:
        iv = _merge_intervals({c: out_iv[c]}, join_distance).get(c, [])
        for s, t in iv:
            ln = t - s + 1
            if ln < min_merge_len or ln > max_merge_len:
                continue
            out.append({"srcid": srcid, "type": el_type,
                        "species": ref_species or rel_species, "chrom": c,
                        "start": s, "end": t, "len": ln, "strand": "+",
                        "relspecies": rel_species})
            srcid += 1
    return out


def _merge_intervals(per: dict, join: int) -> dict:
    out = {}
    for c, iv in per.items():
        iv = sorted(iv)
        merged: list[list] = []
        for s, t in iv:
            if merged and s <= merged[-1][1] + join + 1:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        out[c] = [tuple(m) for m in merged]
    return out


def _iv_intersect(a, b):
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        t = min(a[i][1], b[j][1])
        if s <= t:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _iv_union(a, b):
    iv = sorted(a + b)
    out: list[list] = []
    for s, t in iv:
        if out and s <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(m) for m in out]


def _iv_subtract(a, b):
    out = []
    for s, t in a:
        cur = s
        for bs, bt in b:
            if bt < cur or bs > t:
                continue
            if bs > cur:
                out.append((cur, bs - 1))
            cur = max(cur, bt + 1)
            if cur > t:
                break
        if cur <= t:
            out.append((cur, t))
    return out


# ------------------------------------------------------------------ csv2feat

def csv2feat(loci: list[dict], bed, *, min_len: int = 4,
             max_len: int = 1_000_000_000, min_overlap: int = 1) -> list[dict]:
    """csv2feat: map each element onto overlapping BED features
    (csv2feat.cpp); emits one row per (element, feature) with overlap
    base count."""
    out = []
    for e in loci:
        if not (min_len <= e["len"] <= max_len):
            continue
        for ft in bed.overlapping(e["chrom"], e["start"], e["end"] + 1):
            ov = min(e["end"] + 1, ft.end) - max(e["start"], ft.start)
            if ov >= min_overlap:
                out.append({**e, "feature": ft.name or ft.chrom,
                            "feat_start": ft.start, "feat_end": ft.end - 1,
                            "overlap": ov})
    return out


def write_csv2feat(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","Feature","FeatStart","FeatEnd","Overlap"\n')
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'"{e["feature"]}",{e["feat_start"]},{e["feat_end"]},'
                    f'{e["overlap"]}\n')


# ----------------------------------------------------------------- csv2stats

def csv2stats(loci: list[dict], genome, *, min_len: int = 10,
              max_len: int = 1_000_000_000) -> list[dict]:
    """csv2stats: per-element base composition (A,C,G,T,N counts + GC%)
    from the assembly (csv2stats.cpp)."""
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    out = []
    for e in loci:
        if not (min_len <= e["len"] <= max_len) or e["chrom"] not in starts:
            continue
        s0 = starts[e["chrom"]]
        a = max(0, e["start"])
        b = min(lens[e["chrom"]], e["end"] + 1)
        codes = np.asarray(genome.seq[s0 + a:s0 + b])
        cnt = np.bincount(np.minimum(codes, 4), minlength=5)
        acgt = int(cnt[:4].sum())
        out.append({**e, "a": int(cnt[0]), "c": int(cnt[1]),
                    "g": int(cnt[2]), "t": int(cnt[3]), "n": int(cnt[4]),
                    "gc_pct": 100.0 * (cnt[1] + cnt[2]) / max(acgt, 1)})
    return out


def write_csv2stats(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","A","C","G","T","N","GCPct"\n')
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'{e["a"]},{e["c"]},{e["g"]},{e["t"]},{e["n"]},'
                    f'{e["gc_pct"]:.3f}\n')


# ----------------------------------------------------------- processcsvfiles

PCF_MODE_STANDARD = 0   # identity = matches/(matches+mismatches)
PCF_MODE_IDENTITY = 1   # identity = matches/corelen
PCF_MODE_ALIGNED = 2    # (matches+mismatches)/corelen, clamped 100
PCF_MODE_SCORE = 3      # score/10


def process_csv_files(ref_rows: list[dict], rel_sets: dict, *,
                      mode: int = PCF_MODE_STANDARD, min_len: int = 0,
                      max_len: int = 1_000_000_000,
                      exclude_refids: set | None = None) -> list[dict]:
    """processcsvfiles: join ref elements with rel outspecies rows by
    SrcID, emitting one identity value per rel file per element
    (ProcessCSVfiles.cpp:604-665 identity modes)."""
    rel_by_id = {name: {e["srcid"]: e for e in rows}
                 for name, rows in rel_sets.items()}
    names = sorted(rel_sets)
    out = []
    for e in ref_rows:
        if not (min_len <= e["len"] <= max_len):
            continue
        if exclude_refids and e["srcid"] in exclude_refids:
            continue
        idents = {}
        for name in names:
            r = rel_by_id[name].get(e["srcid"])
            if r is None:
                idents[name] = 0.0
                continue
            m, mm = r.get("matches", 0), r.get("mismatches", 0)
            if mode == PCF_MODE_STANDARD:
                idents[name] = 100.0 * m / (m + mm) if m + mm else 0.0
            elif mode == PCF_MODE_IDENTITY:
                idents[name] = 100.0 * m / max(e["len"], 1)
            elif mode == PCF_MODE_ALIGNED:
                idents[name] = min(100.0, 100.0 * (m + mm) / max(e["len"], 1))
            else:
                idents[name] = r.get("score", 0) / 10.0
        out.append({**e, "identities": idents})
    return out


def write_process_csv(path, rows: list[dict], names: list[str]) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len"' + "".join(f',"{n}"' for n in names) + "\n")
        for e in rows:
            vals = "".join(f',{e["identities"][n]:.3f}' for n in names)
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]}'
                    f'{vals}\n')


# --------------------------------------------------------- genhyperdropouts

HDO_DROPOUTS = 0     # ref elements with no qualifying rel overlap
HDO_INTERSECT = 1    # ref elements with qualifying rel overlap
HDO_REFUNIQUE = 2    # ref elements whose loci (joined) absent from rel
HDO_COMBINED = 3     # all ref elements annotated with overlap class


def hyper_dropouts(ref: list[dict], rel: list[dict], *, mode: int = 0,
                   overlap_bases: int = 10, overlap_pct: int = 50,
                   min_len: int = 0, max_len: int = 1_000_000,
                   join_overlap: int = 4) -> list[dict]:
    """genhyperdropouts: classify ref hyper elements by overlap with rel
    elements (genhyperdropouts.cpp -p modes). A rel overlap qualifies
    when >= overlap_bases and >= overlap_pct% of the ref length; ref
    elements whose start loci differ by <= join_overlap are treated as
    one joined core for uniqueness (ref -j semantics)."""
    rel_per: dict[str, list] = {}
    for e in rel:
        rel_per.setdefault(e["chrom"], []).append((e["start"], e["end"]))
    for v in rel_per.values():
        v.sort()
    out = []
    seen_starts: dict[str, list] = {}
    for e in ref:
        if not (min_len <= e["len"] <= max_len):
            continue
        joined = False
        lst = seen_starts.setdefault(e["chrom"], [])
        for s in lst:
            if abs(e["start"] - s) <= join_overlap:
                joined = True
                break
        if not joined:
            lst.append(e["start"])
        best = 0
        for s, t in rel_per.get(e["chrom"], ()):
            if s > e["end"]:
                break
            ov = min(t, e["end"]) - max(s, e["start"]) + 1
            if ov > best:
                best = ov
        qualifies = (best >= overlap_bases
                     and 100 * best >= overlap_pct * e["len"])
        cls = "intersect" if qualifies else "dropout"
        if joined:
            cls += "+joined"
        if mode == HDO_DROPOUTS and qualifies:
            continue
        if mode == HDO_INTERSECT and not qualifies:
            continue
        if mode == HDO_REFUNIQUE and (qualifies or joined):
            continue
        out.append({**e, "class": cls, "overlap": best})
    return out
