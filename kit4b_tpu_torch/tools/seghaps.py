"""seghaplotypes: full binned founder-segment calling engine.

The port's copy of kit4b_tpu/tools/seghaps.py (host only), held
equal to it by tests/test_torch_haplotypes.py.

Depth parity with `ngskit4b seghaplotypes` (ngskit4b/seghaplotypes.cpp
CSegHaplotypes, 2031 LoC): founder-tagged SAM parsing with per-chrom bin
grids, SNP-marker confidence boosting (ParseSAMAlignments:754-776,
GenBinnedSegments:1111-1112), weighted smoothing (ApplySmoothing:1206),
two-stage segment calling with neighbor interpolation
(IdentifySegments:1243-1348), score-run BED emission (genBED:1350-1438)
split per founder, and per-founder raw-alignment BEDs
(GenerateAlignmentBEDs:1560-1620).

Processing modes (seghaplotypes.cpp:71): 0 = bin counts of unique loci
only (eMSHDefault), 1 = all alignments including multi-loci (eMSHSegAll).

The bin grids are numpy [n_founders, n_bins] arrays per target sequence;
smoothing/calling/interpolation are vectorized over bins rather than the
reference's per-bin pointer walks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.sam import read_sam
from .pangenes import TAG_TERM, split_founder

BED_NO_SCORE = 0x0fff  # cBEDNoScore analog: sentinel "called, unscored"


def load_snpmarker_sites(path) -> dict:
    """Load SNP marker loci from a snpmarkers CSV -> {chrom: sorted int64
    loci}. Accepts this framework's layout ("MarkerID","Chrom","Loci",...)
    and the reference's snpmarkers layout (field 1 = "ancestor:chrom",
    field 2 = loci; 4 + 9*parents fields, ProcessSnpmarkersSNPs
    seghaplotypes.cpp:1644-1800)."""
    sites: dict[str, list] = {}
    with open(path) as f:
        header = f.readline()
        ours = '"Chrom"' in header
        for line in f:
            fields = [t.strip().strip('"') for t in line.rstrip().split(",")]
            if len(fields) < 3:
                continue
            if ours:
                chrom, loci = fields[1], int(fields[2])
            else:
                chrom = fields[0].split(":", 1)[-1]
                loci = int(fields[1])
            sites.setdefault(chrom, []).append(loci)
    return {c: np.unique(np.asarray(v, np.int64)) for c, v in sites.items()}


@dataclass
class SamLoci:
    """tsSHSAMloci analog (seghaplotypes.h:32)."""
    founder: str
    chrom: str
    loci: int           # 0-based start
    align_len: int
    n_marker_snps: int = 0
    cnt: int = 1


@dataclass
class TargSeq:
    """tsTargSeq analog: per target sequence bin grid."""
    name: str
    length: int
    bins: np.ndarray = field(default=None)        # raw [F, NB] int64
    smoothed: np.ndarray = field(default=None)    # [F, NB] int64
    called: np.ndarray = field(default=None)      # [F, NB] int32 scores
    f_called: np.ndarray = field(default=None)    # [NB] bool
    f_infer: np.ndarray = field(default=None)     # [NB] bool


class SegHapEngine:
    """CSegHaplotypes equivalent over founder-tagged SAM alignments."""

    def __init__(self, *, bin_size_kbp: int = 10, min_bin_score: int = 10,
                 min_bin_prop: float = 0.2, snp_marker_mult: int = 5,
                 unique_loci: bool = True, dont_score: bool = False):
        self.bin_size = bin_size_kbp * 1000
        self.min_bin_score = min_bin_score
        self.min_bin_prop = min_bin_prop
        self.snp_marker_mult = snp_marker_mult
        self.unique_loci = unique_loci
        self.dont_score = dont_score
        self.founders: list[str] = []
        self.targs: dict[str, TargSeq] = {}
        self.loci: list[SamLoci] = []
        self.marker_sites: dict = {}

    # --- ingestion -------------------------------------------------------
    def add_founder(self, name: str) -> int:
        if name not in self.founders:
            self.founders.append(name)
        return self.founders.index(name)

    def load_markers(self, path) -> int:
        self.marker_sites = load_snpmarker_sites(path)
        return sum(len(v) for v in self.marker_sites.values())

    def parse_sam(self, path) -> int:
        """ParseSAMAlignments: @SQ founder-tag discovery + alignment loci
        collection with marker-overlap counts (the reference counts any
        marker site within the alignment span, without base checking —
        seghaplotypes.cpp:757-776)."""
        n = 0
        with open(path) as f:
            for line in f:
                if not line.startswith("@"):
                    break
                if line.startswith("@SQ"):
                    tags = dict(t.split(":", 1) for t in
                                line.rstrip().split("\t")[1:] if ":" in t)
                    founder, chrom = split_founder(tags.get("SN", ""))
                    self.add_founder(founder or "NA")
                    ln = int(tags.get("LN", 0))
                    t = self.targs.get(chrom)
                    if t is None:
                        self.targs[chrom] = TargSeq(chrom, ln)
                    elif ln > t.length:
                        t.length = ln
        for rec in read_sam(path):
            if not rec.is_mapped:
                continue
            founder, chrom = split_founder(rec.rname)
            founder = founder or "NA"
            self.add_founder(founder)
            loci = rec.pos - 1
            alen = len(rec.seq) if rec.seq != "*" else 100
            nm = 0
            m = self.marker_sites.get(chrom)
            if m is not None and len(m):
                j0 = np.searchsorted(m, loci)
                j1 = np.searchsorted(m, loci + alen)
                nm = min(int(j1 - j0), 127)
            t = self.targs.get(chrom)
            if t is None:
                t = self.targs[chrom] = TargSeq(chrom, loci + alen)
            elif loci + alen > t.length:
                t.length = loci + alen
            self.loci.append(SamLoci(founder, chrom, loci, alen, nm))
            n += 1
        return n

    # --- binning ---------------------------------------------------------
    def _collapse_loci(self) -> list[SamLoci]:
        """Unique-loci reduction (GenBinnedSegments:1080-1099): multiple
        alignments at the same (founder, chrom, loci) collapse to one
        entry; mode all (eMSHSegAll) keeps the multiplicity in cnt."""
        byk: dict[tuple, SamLoci] = {}
        for sl in self.loci:
            key = (sl.founder, sl.chrom, sl.loci)
            cur = byk.get(key)
            if cur is None:
                byk[key] = SamLoci(sl.founder, sl.chrom, sl.loci,
                                   sl.align_len, sl.n_marker_snps, 1)
            elif not self.unique_loci:
                cur.cnt += 1
        return list(byk.values())

    def bin_counts(self) -> None:
        F = len(self.founders)
        fidx = {f: i for i, f in enumerate(self.founders)}
        for t in self.targs.values():
            nb = max(1, -(-t.length // self.bin_size))
            t.bins = np.zeros((F, nb), np.int64)
        for sl in self._collapse_loci():
            t = self.targs[sl.chrom]
            b = sl.loci // self.bin_size
            boost = (self.snp_marker_mult - 1) * sl.n_marker_snps * sl.cnt
            t.bins[fidx[sl.founder], b] += sl.cnt + boost

    def apply_smoothing(self) -> None:
        """ApplySmoothing (seghaplotypes.cpp:1206): each bin gains half of
        each immediately adjacent bin's raw counts."""
        for t in self.targs.values():
            r = t.bins
            s = r.copy()
            s[:, 1:] += r[:, :-1] // 2
            s[:, :-1] += r[:, 1:] // 2
            t.smoothed = s

    # --- calling ---------------------------------------------------------
    def _bin_lens(self, t: TargSeq) -> np.ndarray:
        nb = t.bins.shape[1]
        lens = np.full(nb, self.bin_size, np.int64)
        rem = t.length - (nb - 1) * self.bin_size
        if rem > 0:
            lens[-1] = rem
        return lens

    def identify_segments(self, interpolate: bool) -> int:
        """IdentifySegments (seghaplotypes.cpp:1243): seed pass calls bins
        with total smoothed counts >= min_bin_score; founder present when
        its smoothed count >= min_bin_score AND >= min_bin_prop of the
        total; score = counts per 100Kbp clamped to [2, 999] (:1330-1341).
        Interpolation passes copy the call pattern from a called neighbor
        (parity-alternating preference, :1286-1316) until fixpoint."""
        n_called = 0
        for t in self.targs.values():
            if t.called is None:
                F, nb = t.smoothed.shape
                t.called = np.zeros((F, nb), np.int32)
                t.f_called = np.zeros(nb, bool)
                t.f_infer = np.zeros(nb, bool)
            tot = t.smoothed.sum(axis=0)
            lens = self._bin_lens(t)
            if not interpolate:
                seed = (~t.f_called) & (tot >= self.min_bin_score)
                if not seed.any():
                    continue
                prop_ok = ((t.smoothed >= self.min_bin_score)
                           & (t.smoothed >= self.min_bin_prop
                              * np.maximum(tot, 1)[None, :]))
                if self.dont_score:
                    score = np.where(prop_ok, BED_NO_SCORE, 0)
                else:
                    norm = np.maximum(
                        2, t.smoothed * 100_000 // np.maximum(lens, 1))
                    score = np.where(prop_ok, np.minimum(norm, 999), 0)
                t.called[:, seed] = score[:, seed].astype(np.int32)
                t.f_called |= seed
                n_called += int(seed.sum())
            else:
                nb = len(tot)
                todo = np.nonzero((~t.f_called)
                                  & (tot < self.min_bin_score))[0]
                for b in todo.tolist():
                    prev_ok = b > 0 and t.f_called[b - 1]
                    next_ok = b + 1 < nb and t.f_called[b + 1]
                    if b & 1:
                        src = b - 1 if prev_ok else (b + 1 if next_ok
                                                     else None)
                    else:
                        src = b + 1 if next_ok else (b - 1 if prev_ok
                                                     else None)
                    if src is None:
                        continue
                    pat = t.called[:, src] > 0
                    t.called[:, b] = np.where(
                        pat, BED_NO_SCORE if self.dont_score else 1, 0)
                    t.f_called[b] = True
                    t.f_infer[b] = True
                    n_called += 1
        return n_called

    def call(self) -> int:
        """Full calling ladder (GenBinnedSegments:1125-1129): one seed
        pass, then interpolation passes until no further bins call."""
        self.bin_counts()
        self.apply_smoothing()
        total = self.identify_segments(False)
        while True:
            n = self.identify_segments(True)
            if n == 0:
                break
            total += n
        return total

    # --- output ----------------------------------------------------------
    def gen_bed(self, out_path, *, founder: str | None = None,
                track_name: str = "seghaps",
                track_descr: str = "founder segments") -> int:
        """genBED (seghaplotypes.cpp:1350): per-founder score runs;
        adjacent called bins with the SAME score merge into one row,
        score changes start a new row (so a haplotype segment spanning
        varying coverage emits one row per score run, exactly as the
        reference's look-ahead loop does)."""
        n = 0
        with open(out_path, "w") as f:
            f.write(f'track name="{track_name}" '
                    f'description="{track_descr}" useScore=1\n')
            for fi, fname in enumerate(self.founders):
                if founder is not None and fname != founder:
                    continue
                for t in self.targs.values():
                    if t.called is None:
                        continue
                    lens = self._bin_lens(t)
                    starts = np.concatenate(
                        [[0], np.cumsum(lens)[:-1]]).astype(np.int64)
                    row = np.where(t.f_called, t.called[fi], 0)
                    b = 0
                    nb = len(row)
                    while b < nb:
                        if row[b] == 0:
                            b += 1
                            continue
                        score = int(row[b])
                        s0 = int(starts[b])
                        e = s0
                        while b < nb and row[b] == score:
                            e += int(lens[b])
                            b += 1
                        f.write(f"{t.name}\t{s0}\t{e}\t{fname}"
                                f"\t{score}\n")
                        n += 1
        return n

    def gen_beds(self, out_path, *, no_split: bool = False,
                 track_name: str = "seghaps",
                 track_descr: str = "founder segments") -> dict:
        """Per-founder split output `<out>.<founder>.bed` (default) or a
        single combined file (bNoSplit, GenBinnedSegments:1137-1196)."""
        written = {}
        if no_split:
            written[out_path] = self.gen_bed(
                out_path, track_name=track_name, track_descr=track_descr)
            return written
        for fname in self.founders:
            p = f"{out_path}.{fname}.bed"
            written[p] = self.gen_bed(
                p, founder=fname,
                track_name=f"{track_name} {out_path}:{fname}",
                track_descr=f"{track_descr} {out_path}:{fname}")
        return written

    def gen_alignment_beds(self, sam_path) -> dict:
        """GenerateAlignmentBEDs (seghaplotypes.cpp:1560): one BED per
        founder named `<samfile>.<founder>.bed` holding every accepted
        alignment span for that founder."""
        written = {}
        for fname in self.founders:
            p = f"{sam_path}.{fname}.bed"
            with open(p, "w") as f:
                f.write(f'track name="FAL {fname}" description='
                        f'"Founder Alignment Loci {fname}"\n')
                k = 0
                for sl in self.loci:
                    if sl.founder != fname:
                        continue
                    f.write(f"{sl.chrom}\t{sl.loci}\t"
                            f"{sl.loci + sl.align_len}\t{fname}\n")
                    k += 1
            written[p] = k
        return written


def run_seghaplotypes(sam_paths: list, out_path, *, bin_size_kbp: int = 10,
                      min_bin_score: int = 10, min_bin_prop: float = 0.2,
                      snp_marker_mult: int = 5, unique_loci: bool = True,
                      dont_score: bool = False, no_split: bool = False,
                      snp_markers: str | None = None,
                      alignment_beds: bool = False,
                      track_name: str = "seghaps",
                      track_descr: str = "founder segments") -> dict:
    """End-to-end seghaplotypes run over one or more founder-tagged SAM
    files. Returns {"called_bins", "founders", "beds", "align_beds"}."""
    eng = SegHapEngine(bin_size_kbp=bin_size_kbp,
                       min_bin_score=min_bin_score,
                       min_bin_prop=min_bin_prop,
                       snp_marker_mult=snp_marker_mult,
                       unique_loci=unique_loci, dont_score=dont_score)
    if snp_markers:
        eng.load_markers(snp_markers)
    n_align = 0
    for p in sam_paths:
        n_align += eng.parse_sam(p)
    called = eng.call()
    beds = eng.gen_beds(out_path, no_split=no_split,
                        track_name=track_name, track_descr=track_descr)
    align_beds = {}
    if alignment_beds and sam_paths:
        align_beds = eng.gen_alignment_beds(sam_paths[0])
    return {"called_bins": called, "founders": list(eng.founders),
            "beds": beds, "align_beds": align_beds,
            "n_alignments": n_align}
