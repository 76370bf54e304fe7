"""pangenome + seghaplotypes: founder-tagged pangenome processing.

The port's copy of kit4b_tpu/tools/pangenes.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Capability parity with `ngskit4b pangenome` (ngskit4b/pangenome.cpp
CPangenome: PrefixFasta, FilterSAM, GenBinnedWiggle modes 0-3) and
`ngskit4b seghaplotypes` (ngskit4b/seghaplotypes.cpp CSegHaplotypes:
per-founder binned segment calling over pangenome alignments).

Founder tags follow the reference convention (seghaplotypes.h:4-5): a
chromosome in the pangenome is named `<founder>|#<chrom>` — the tag is
alpha-numeric and terminated by the two chars "|#".
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..io.sam import read_sam

TAG_TERM = "|#"


def split_founder(rname: str) -> tuple[str, str]:
    """`founder|#chrom` -> (founder, chrom); untagged -> ("", rname)."""
    i = rname.find(TAG_TERM)
    if i <= 0:
        return "", rname
    return rname[:i], rname[i + len(TAG_TERM):]


def prefix_fasta(in_path, out_path, prefix: str) -> int:
    """pangenome -m0: prefix every fasta descriptor with `prefix|#`."""
    n = 0
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith(">"):
                fout.write(f">{prefix}{TAG_TERM}{line[1:]}")
                n += 1
            else:
                fout.write(line)
    return n


def filter_sam_prefix(in_path, out_path, prefix: str) -> dict:
    """pangenome -m1: keep SAM alignments whose target carries the
    founder prefix (header @SQ lines filtered to match)."""
    want = prefix + TAG_TERM
    stats = {"kept": 0, "dropped": 0}
    with open(in_path) as fin, open(out_path, "w") as fout:
        for line in fin:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    sn = [f for f in line.split("\t") if
                          f.startswith("SN:")]
                    if sn and not sn[0][3:].startswith(want):
                        continue
                fout.write(line)
                continue
            rname = line.split("\t", 3)[2]
            if rname.startswith(want):
                fout.write(line)
                stats["kept"] += 1
            else:
                stats["dropped"] += 1
    return stats


def _bin_counts(sam_path, bin_size: int, unique_loci: bool,
                strip_tag: bool = False):
    """Per (founder?, chrom) binned alignment-start counts.

    Returns ({(founder, chrom): int32 bins}, {chrom: max_end}).
    """
    counts: dict[tuple, dict] = defaultdict(lambda: defaultdict(int))
    seen: set = set()
    lens: dict[str, int] = defaultdict(int)
    for rec in read_sam(sam_path):
        if not rec.is_mapped:
            continue
        founder, chrom = split_founder(rec.rname) if strip_tag \
            else ("", rec.rname)
        loci = rec.pos - 1
        if unique_loci:
            key = (founder, chrom, loci)
            if key in seen:
                continue
            seen.add(key)
        counts[(founder, chrom)][loci // bin_size] += 1
        lens[chrom] = max(lens[chrom], loci + len(rec.seq))
    return counts, lens


def binned_wiggle(sam_path, out_path, bin_kbp: int = 10,
                  unique_loci: bool = False,
                  track_name: str = "pangenome") -> int:
    """pangenome -m2/-m3: UCSC wiggle of alignment density per bin
    (GenBinnedWiggle pangenome.cpp:816). -m3 counts unique loci only."""
    bin_size = bin_kbp * 1000
    counts, _ = _bin_counts(sam_path, bin_size, unique_loci)
    n = 0
    with open(out_path, "w") as f:
        f.write(f'track type=wiggle_0 name="{track_name}"\n')
        for (_, chrom), bins in sorted(counts.items()):
            f.write(f"fixedStep chrom={chrom} start=1 "
                    f"step={bin_size} span={bin_size}\n")
            for b in range(max(bins) + 1):
                f.write(f"{bins.get(b, 0)}\n")
                n += 1
    return n


@dataclass
class Segment:
    founder: str
    chrom: str
    start: int          # 0-based
    end: int
    score: int          # summed bin counts


def seg_haplotypes(sam_paths: list, bin_kbp: int = 10,
                   min_bin_score: int = 10, min_bin_prop: float = 0.3,
                   unique_loci: bool = True,
                   marker_loci: dict | None = None,
                   marker_mult: int = 25) -> list[Segment]:
    """seghaplotypes: call per-founder presence segments from pangenome
    alignments (CSegHaplotypes::GenBinnedSegments).

    Alignments target `founder|#chrom` sequences. Each chrom is split
    into bin_kbp bins; a founder is present in a bin when its count is
    >= min_bin_score AND >= min_bin_prop of all founders' counts there.
    Alignments overlapping SNP marker loci (marker_loci: chrom -> sorted
    int array) are weighted by marker_mult (the -c confidence boost).
    Adjacent present bins merge into Segments.
    """
    bin_size = bin_kbp * 1000
    counts: dict[tuple, dict] = defaultdict(lambda: defaultdict(int))
    seen: set = set()
    for path in sam_paths:
        for rec in read_sam(path):
            if not rec.is_mapped:
                continue
            founder, chrom = split_founder(rec.rname)
            if not founder:
                continue
            loci = rec.pos - 1
            if unique_loci:
                key = (founder, chrom, loci)
                if key in seen:
                    continue
                seen.add(key)
            w = 1
            if marker_loci is not None and chrom in marker_loci:
                m = marker_loci[chrom]
                j = np.searchsorted(m, loci)
                if j < len(m) and m[j] < loci + len(rec.seq):
                    w = marker_mult
            counts[(chrom, loci // bin_size)][founder] += w

    # founder presence per bin, then merge adjacent bins
    present: dict[tuple, list] = defaultdict(list)  # (founder,chrom)->bins
    for (chrom, b), fc in counts.items():
        tot = sum(fc.values())
        for founder, c in fc.items():
            if c >= min_bin_score and c / tot >= min_bin_prop:
                present[(founder, chrom)].append((b, c))
    segs: list[Segment] = []
    for (founder, chrom), bins in sorted(present.items()):
        bins.sort()
        start_b, prev_b, score = bins[0][0], bins[0][0], bins[0][1]
        for b, c in bins[1:]:
            if b == prev_b + 1:
                prev_b, score = b, score + c
            else:
                segs.append(Segment(founder, chrom, start_b * bin_size,
                                    (prev_b + 1) * bin_size, score))
                start_b, prev_b, score = b, b, c
        segs.append(Segment(founder, chrom, start_b * bin_size,
                            (prev_b + 1) * bin_size, score))
    return segs


def write_segments_bed(path, segs: list, track_name: str = "seghaps",
                       track_descr: str = "founder segments") -> None:
    with open(path, "w") as f:
        f.write(f'track name="{track_name}" '
                f'description="{track_descr}"\n')
        for s in segs:
            f.write(f"{s.chrom}\t{s.start}\t{s.end}\t{s.founder}"
                    f"\t{min(s.score, 1000)}\t+\n")
