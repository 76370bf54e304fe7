"""hypers: ultra- and hyper-conserved element discovery over multialignments,
the port's copy of kit4b_tpu/tools/hypers.py (host only;
tests/test_torch_rehomed.py holds it equal to the original statement for
statement): cores of at least `min_core_len` reference bases where every
species matches the reference, with at most `max_mismatches` mismatching
columns, reported in reference coordinates, with a binned length
distribution and an optional region classification against a gene model.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.malign import MAlign


@dataclass
class HyperEl:
    chrom: str
    start: int            # ref coords, 0-based
    end: int              # exclusive
    length: int
    mismatch_cols: int
    n_species: int


def find_hypercores(ma: MAlign, *, min_core_len: int = 50,
                    max_mismatches: int = 0,
                    min_species: int = 2) -> list[HyperEl]:
    out: list[HyperEl] = []
    for blk in ma.blocks:
        rows = blk.rows
        n, cols = rows.shape
        if n < min_species or cols == 0:
            continue
        ref = rows[0]
        base_ok = (rows < 4).all(axis=0)      # gap/N columns break cores
        match = base_ok & (rows == ref[None, :]).all(axis=0)
        ref_real = ref < 4
        loci = np.cumsum(ref_real) - 1 + blk.ref_start

        # gap-free segments, then maximal <=max_mismatches windows inside
        d = np.diff(np.concatenate([[0], base_ok.astype(np.int8), [0]]))
        for a, b in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            l = a
            while l < b:
                if not match[l]:
                    l += 1
                    continue
                # extend right allowing <= max_mismatches mismatch columns
                mm_pos = []
                r = l
                last_match = l
                j = l
                while j < b:
                    if match[j]:
                        last_match = j
                    else:
                        if len(mm_pos) == max_mismatches:
                            break
                        mm_pos.append(j)
                    j += 1
                r = last_match
                length = int(loci[r]) - int(loci[l]) + 1
                if length >= min_core_len:
                    used = int((~match[l:r + 1]).sum())
                    out.append(HyperEl(blk.ref_chrom, int(loci[l]),
                                       int(loci[r]) + 1, length, used, n))
                l = (mm_pos[0] + 1) if mm_pos else r + 1
    out.sort(key=lambda e: (e.chrom, e.start))
    return out


def length_distribution(els: list[HyperEl], *, num_bins: int = 1000,
                        bin_delta: int = 0) -> list[tuple[int, int]]:
    """(bin_start_len, count) summary — genhypers' NumBins/BinDelta mode."""
    if not els:
        return []
    longest = max(e.length for e in els)
    if bin_delta <= 0:
        bin_delta = max(1, -(-longest // num_bins))
    counts: dict[int, int] = {}
    for e in els:
        b = (e.length // bin_delta) * bin_delta
        counts[b] = counts.get(b, 0) + 1
    return sorted(counts.items())


def write_hypers_csv(path, els: list[HyperEl]) -> None:
    with open(path, "w") as f:
        f.write('"ElID","Chrom","StartLoci","EndLoci","Len",'
                '"MismatchCols","NumSpecies"\n')
        for i, e in enumerate(els, 1):
            f.write(f'{i},"{e.chrom}",{e.start},{e.end - 1},{e.length},'
                    f'{e.mismatch_cols},{e.n_species}\n')


def write_hypers_bed(path, els: list[HyperEl]) -> None:
    with open(path, "w") as f:
        for i, e in enumerate(els, 1):
            f.write(f"{e.chrom}\t{e.start}\t{e.end}\thyper{i}\t"
                    f"{min(1000, e.length)}\t+\n")


def classify_regions(els: list[HyperEl], classifier) -> dict:
    """Region classification of hyper elements against a gene model
    (CHyperEls::MapRegions — per-element priority region ordinal and a
    7-region count summary). classifier: io.biobed.RegionClassifier.
    Returns {"per_el": [ordinal], "counts": {region_name: n}}."""
    from ..tools.locistats import REGION_NAMES
    ords = [classifier.region_ordinal(e.chrom, e.start, e.end - 1)
            for e in els]
    counts = {name: 0 for name in REGION_NAMES}
    for o in ords:
        counts[REGION_NAMES[o]] += 1
    return {"per_el": ords, "counts": counts}


def write_hypers_region_csv(path, els: list[HyperEl],
                            classification: dict) -> None:
    from ..tools.locistats import REGION_NAMES
    with open(path, "w") as f:
        f.write('"SrcID","Type","Species","Chrom","StartLoci","EndLoci",'
                '"Len","Features","Region"\n')
        for i, (e, o) in enumerate(zip(els, classification["per_el"])):
            f.write(f'{i + 1},"hypercore","ref","{e.chrom}",{e.start},'
                    f'{e.end - 1},{e.length},{o},"{REGION_NAMES[o]}"\n')
