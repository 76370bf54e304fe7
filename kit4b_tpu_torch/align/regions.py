"""Coverage regions of interest, SAM filtering by chromosome and DE counts,
the port's copy of kit4b_tpu/align/regions.py (host only;
tests/test_torch_rehomed.py holds it equal to the original statement for
statement): coverage_from_sam and locate_roi (locateroi, genwiggle),
filter_sam_by_chrom (filtchrom) and de_counts (gendeseq: a feature x
sample counts matrix).
"""
from __future__ import annotations

import re

import numpy as np

from ..io.bed import BedFeature
from ..io.sam import read_sam


def coverage_from_sam(sam_path, chrom_lengths: dict) -> dict:
    """Per-chrom coverage arrays from mapped SAM records."""
    cov = {c: np.zeros(ln, np.int32) for c, ln in chrom_lengths.items()}
    for rec in read_sam(sam_path):
        if not rec.is_mapped or rec.rname not in cov:
            continue
        start = rec.pos - 1
        end = min(start + len(rec.seq), len(cov[rec.rname]))
        cov[rec.rname][start:end] += 1
    return cov


def locate_roi(cov: dict, min_cov: int = 2, min_len: int = 100,
               merge_gap: int = 0) -> list[BedFeature]:
    """Contiguous regions with coverage >= min_cov, at least min_len bp."""
    out: list[BedFeature] = []
    n = 0
    for chrom, c in cov.items():
        above = c >= min_cov
        if merge_gap:
            # close small gaps: dilate-erode via cumsum trick (host scale)
            pass
        d = np.diff(above.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0] + 1
        if above[0]:
            starts = np.concatenate([[0], starts])
        if above[-1]:
            ends = np.concatenate([ends, [len(c)]])
        for s, e in zip(starts, ends):
            if e - s >= min_len:
                n += 1
                out.append(BedFeature(chrom, int(s), int(e), f"ROI{n}",
                                      int(c[s:e].mean())))
    return out


def filter_sam_by_chrom(in_path, out_path, include: list[str] | None = None,
                        exclude: list[str] | None = None) -> dict:
    """filtchrom: copy SAM records whose RNAME passes include/exclude
    regexes (FilterSAMAlignments.cpp semantics: include wins when both)."""
    inc = [re.compile(p) for p in (include or [])]
    exc = [re.compile(p) for p in (exclude or [])]
    stats = {"kept": 0, "dropped": 0}
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("@"):
                fout.write(line)
                continue
            rname = line.split("\t", 3)[2]
            ok = True
            if inc:
                ok = any(p.search(rname) for p in inc)
            elif exc:
                ok = not any(p.search(rname) for p in exc)
            if ok:
                fout.write(line)
                stats["kept"] += 1
            else:
                stats["dropped"] += 1
    return stats


def de_counts(sample_sams: dict, bed) -> tuple[list[str], dict]:
    """gendeseq: feature x sample counts matrix.

    sample_sams: sample name -> SAM path; bed: BedFile of features.
    Returns (sample order, {feature name: [counts per sample]}).
    """
    samples = list(sample_sams)
    counts: dict[str, list[int]] = {}
    for si, name in enumerate(samples):
        for rec in read_sam(sample_sams[name]):
            if not rec.is_mapped:
                continue
            start = rec.pos - 1
            for ft in bed.overlapping(rec.rname, start,
                                      start + len(rec.seq)):
                key = ft.name or f"{ft.chrom}:{ft.start}-{ft.end}"
                counts.setdefault(key, [0] * len(samples))[si] += 1
    return samples, counts


def write_de_counts(path, samples: list[str], counts: dict) -> None:
    with open(path, "w") as f:
        f.write('"Feature",' + ",".join(f'"{s}"' for s in samples) + "\n")
        for feat in sorted(counts):
            f.write(f'"{feat}",' + ",".join(map(str, counts[feat])) + "\n")
