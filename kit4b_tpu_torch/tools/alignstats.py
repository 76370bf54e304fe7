"""Multialignment statistics and loci mapping over io/malign.py's bundle, the
port's copy of kit4b_tpu/tools/alignstats.py (host only;
tests/test_torch_rehomed.py holds it equal to the original statement for
statement): genalignstats (aligned and identical columns, modes 0-2),
genalignconf (block conformance per chromosome or genome), loci2core (per-
species coverage and identity of loci) and ref2relloci (reference loci
projected into a relative species' coordinates).
"""
from __future__ import annotations

import numpy as np

from .. import dna


def _ref_positions(blk):
    ref = np.asarray(blk.rows[0])
    pos = np.cumsum(ref != dna.BASE_INDEL) - 1 + blk.ref_start
    return ref, pos


def genalignstats(ma, *, mode: int = 0, species: list | None = None,
                  min_species: int = 2) -> dict:
    """genalignstats: column statistics over alignment blocks
    (genalignstats.cpp -m). mode 0: aligned vs identical columns with
    indels counted as aligned; mode 1: columns containing any indel are
    skipped; mode 2: pairwise substitution counts per rel species
    against the reference row."""
    species = species or list(ma.species)
    n_cols = n_ident = n_blocks = 0
    subs: dict[str, np.ndarray] = {
        sp: np.zeros((4, 4), np.int64) for sp in species[1:]}
    aligned_cols: dict[str, int] = {sp: 0 for sp in species[1:]}
    for blk in ma.blocks:
        present = [sp for sp in species if sp in blk.species]
        if len(present) < min_species:
            continue
        n_blocks += 1
        rows = np.stack([np.asarray(blk.rows[blk.species.index(sp)])
                         for sp in present])
        has_indel = (rows == dna.BASE_INDEL).any(axis=0)
        valid = (rows <= 3).all(axis=0)
        if mode == 1:
            cols = valid & ~has_indel
        else:
            cols = valid | has_indel
        n_cols += int(cols.sum())
        ident = valid & (rows == rows[0]).all(axis=0)
        n_ident += int(ident.sum())
        if mode == 2:
            ref = rows[0]
            for i, sp in enumerate(present[1:], start=1):
                rel = rows[i]
                both = (ref <= 3) & (rel <= 3)
                aligned_cols[sp] = aligned_cols.get(sp, 0) + int(both.sum())
                np.add.at(subs.setdefault(sp, np.zeros((4, 4), np.int64)),
                          (ref[both], rel[both]), 1)
    out = {"mode": mode, "n_blocks": n_blocks, "aligned_cols": n_cols,
           "identical_cols": n_ident,
           "identity_pct": 100.0 * n_ident / max(n_cols, 1)}
    if mode == 2:
        out["pairwise"] = {
            sp: {"aligned": aligned_cols.get(sp, 0),
                 "substitutions": int(m.sum() - np.trace(m)),
                 "matrix": m}
            for sp, m in subs.items()}
    return out


def write_alignstats(path, res: dict) -> None:
    with open(path, "w") as f:
        f.write('"Stat","Value"\n')
        f.write(f'"Blocks",{res["n_blocks"]}\n')
        f.write(f'"AlignedCols",{res["aligned_cols"]}\n')
        f.write(f'"IdenticalCols",{res["identical_cols"]}\n')
        f.write(f'"IdentityPct",{res["identity_pct"]:.3f}\n')
        for sp, d in res.get("pairwise", {}).items():
            f.write(f'"Aligned:{sp}",{d["aligned"]}\n')
            f.write(f'"Substitutions:{sp}",{d["substitutions"]}\n')
            bases = "ACGT"
            for i in range(4):
                for j in range(4):
                    if i != j and d["matrix"][i, j]:
                        f.write(f'"Sub:{sp}:{bases[i]}->{bases[j]}",'
                                f'{int(d["matrix"][i, j])}\n')


def genalignconf(ma, *, mode: int = 0, per_chrom: bool = False,
                 min_species: int = 2, max_species: int = 50,
                 min_block_len: int = 0, max_block_len: int = 1 << 40,
                 chrom: str | None = None) -> list[dict]:
    """genalignconf: per-block (mode 1 extended) or per-chrom/genome
    (modes 0/2) alignment conformance summaries (genalignconf.cpp -m):
    block counts, lengths, species depth, identity."""
    acc: dict[str, dict] = {}
    for blk in ma.blocks:
        if chrom and blk.ref_chrom != chrom:
            continue
        ns = len(blk.species)
        if ns < min_species or ns > max_species:
            continue
        ln = len(blk.rows[0])
        if ln < min_block_len or ln > max_block_len:
            continue
        rows = np.stack([np.asarray(r) for r in blk.rows])
        valid = (rows <= 3).all(axis=0)
        ident = valid & (rows == rows[0]).all(axis=0)
        key = blk.ref_chrom if per_chrom else "genome"
        d = acc.setdefault(key, {"n_blocks": 0, "total_len": 0,
                                 "aligned_cols": 0, "identical_cols": 0,
                                 "species_depth": 0})
        d["n_blocks"] += 1
        d["total_len"] += ln
        d["aligned_cols"] += int(valid.sum())
        d["identical_cols"] += int(ident.sum())
        d["species_depth"] += ns
    out = []
    for key in sorted(acc):
        d = acc[key]
        out.append({
            "scope": key, **d,
            "mean_depth": d["species_depth"] / max(d["n_blocks"], 1),
            "identity_pct":
                100.0 * d["identical_cols"] / max(d["aligned_cols"], 1)})
    return out


def write_alignconf(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"Scope","Blocks","TotalLen","AlignedCols",'
                '"IdenticalCols","MeanDepth","IdentityPct"\n')
        for d in rows:
            f.write(f'"{d["scope"]}",{d["n_blocks"]},{d["total_len"]},'
                    f'{d["aligned_cols"]},{d["identical_cols"]},'
                    f'{d["mean_depth"]:.2f},{d["identity_pct"]:.3f}\n')


def loci2core(ma, loci: list[dict], *, species: list | None = None,
              min_core_len: int = 20, max_core_len: int = 1_000_000,
              dist_segs: int = 10) -> list[dict]:
    """loci2core: for each locus of interest, walk the alignment blocks
    covering it and score per-rel-species matches/mismatches/unaligned
    plus a match distribution over dist_segs segments
    (genalignloci2core.cpp -d)."""
    species = species or list(ma.species)
    rels = species[1:]
    out = []
    for e in loci:
        if not (min_core_len <= e["len"] <= max_core_len):
            continue
        per = {sp: {"matches": 0, "mismatches": 0, "unaligned": e["len"],
                    "segs": np.zeros(dist_segs, np.int64)} for sp in rels}
        for blk in ma.blocks:
            if blk.ref_chrom != e["chrom"]:
                continue
            ref, pos = _ref_positions(blk)
            sel = (pos >= e["start"]) & (pos <= e["end"]) & \
                (ref != dna.BASE_INDEL)
            if not sel.any():
                continue
            seg_of = np.minimum(
                ((pos[sel] - e["start"]) * dist_segs) // max(e["len"], 1),
                dist_segs - 1)
            for sp in rels:
                if sp not in blk.species:
                    continue
                rel = np.asarray(blk.rows[blk.species.index(sp)])[sel]
                r = ref[sel]
                both = (rel <= 3) & (r <= 3)
                m = both & (rel == r)
                mm = both & (rel != r)
                d = per[sp]
                d["matches"] += int(m.sum())
                d["mismatches"] += int(mm.sum())
                d["unaligned"] -= int(both.sum())
                np.add.at(d["segs"], seg_of[m], 1)
        for sp in rels:
            d = per[sp]
            out.append({**e, "relspecies": sp, "matches": d["matches"],
                        "mismatches": d["mismatches"],
                        "unaligned": max(d["unaligned"], 0),
                        "segs": d["segs"]})
    return out


def write_loci2core(path, rows: list[dict], dist_segs: int = 10) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","RelSpecies","Matches","Mismatches","Unaligned"'
                + "".join(f',"Seg{i + 1}"' for i in range(dist_segs))
                + "\n")
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'"{e["relspecies"]}",{e["matches"]},'
                    f'{e["mismatches"]},{e["unaligned"]},'
                    + ",".join(str(int(v)) for v in e["segs"]) + "\n")


def ref2relloci(ma, loci: list[dict], *, rel_species: str,
                min_len: int = 20, max_len: int = 100_000_000
                ) -> list[dict]:
    """ref2relloci: project reference-species loci through the
    alignment into rel-species coordinates
    (genalignref2relloci.cpp). A locus maps when at least one block
    covers part of it with the rel species present; output start/end are
    the min/max mapped rel positions, with coverage recorded."""
    out = []
    for e in loci:
        if not (min_len <= e["len"] <= max_len):
            continue
        rel_chrom = None
        rel_lo, rel_hi, covered = None, None, 0
        strand = "+"
        for blk in ma.blocks:
            if blk.ref_chrom != e["chrom"] or rel_species not in blk.species:
                continue
            ref, pos = _ref_positions(blk)
            sel = (pos >= e["start"]) & (pos <= e["end"]) & \
                (ref != dna.BASE_INDEL)
            if not sel.any():
                continue
            ri = blk.species.index(rel_species)
            rel = np.asarray(blk.rows[ri])
            rel_pos = np.cumsum(rel != dna.BASE_INDEL) - 1 + \
                blk.row_start(ri)
            mapped = sel & (rel != dna.BASE_INDEL)
            if not mapped.any():
                continue
            covered += int(mapped.sum())
            mp = rel_pos[mapped]
            lo, hi = int(mp.min()), int(mp.max())
            rel_lo = lo if rel_lo is None else min(rel_lo, lo)
            rel_hi = hi if rel_hi is None else max(rel_hi, hi)
            rel_chrom = blk.row_chrom(ri)
            if blk.strands and blk.strands[ri] == "-":
                strand = "-"
        if rel_lo is not None:
            out.append({**e, "relspecies": rel_species,
                        "rel_chrom": rel_chrom or e["chrom"],
                        "rel_start": rel_lo, "rel_end": rel_hi,
                        "covered": covered, "rel_strand": strand})
    return out


def write_ref2relloci(path, rows: list[dict]) -> None:
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","RelSpecies","RelChrom","RelStart","RelEnd",'
                '"Covered"\n')
        for e in rows:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                    f'"{e["relspecies"]}","{e["rel_chrom"]}",'
                    f'{e["rel_start"]},{e["rel_end"]},{e["covered"]}\n')
