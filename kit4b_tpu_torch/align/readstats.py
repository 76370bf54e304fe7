"""ngsqc: readset quality-control statistics (CReadStats equivalent),
the port's copy of kit4b_tpu/align/readstats.py (host numpy;
matplotlib only for the plots, imported when they are drawn).

Capability parity with `ngskit4b ngsqc` (ngskit4b/ReadStats.cpp:1165
ProcessReadsetDist, :2432 ProcNGSQC): per-cycle base composition, per-cycle
Phred quality distribution, read-length distribution, duplicate rate,
K-mer spectrum, GC distribution. The reference renders plots through its
vendored PLplot fork; here the distributions are emitted as CSV (and a JSON
summary) for any plotting frontend.

Vectorized NumPy accumulation over record batches; the duplicate rate uses
the same lexicographic-sort dedup as the filter stage.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from .. import dna

MAX_CYCLES = 2048
MAX_PHRED = 64


@dataclass
class ReadStats:
    n_reads: int = 0
    n_bases: int = 0
    max_len: int = 0
    # [cycle, base A/C/G/T/N]
    cycle_base: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CYCLES, 5), np.int64))
    # [cycle, phred]
    cycle_qual: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_CYCLES, MAX_PHRED), np.int64))
    len_dist: dict = field(default_factory=dict)
    gc_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(101, np.int64))
    kmer_counts: dict = field(default_factory=dict)
    n_dup: int = 0

    def summary(self) -> dict:
        total = self.cycle_base.sum()
        base_frac = (self.cycle_base.sum(axis=0) / total).tolist() \
            if total else [0] * 5
        mean_q = 0.0
        qtot = self.cycle_qual.sum()
        if qtot:
            mean_q = float((self.cycle_qual.sum(axis=0)
                            * np.arange(MAX_PHRED)).sum() / qtot)
        return {
            "reads": self.n_reads,
            "bases": self.n_bases,
            "max_len": self.max_len,
            "mean_len": round(self.n_bases / max(1, self.n_reads), 2),
            "base_fractions_ACGTN": [round(x, 5) for x in base_frac],
            "gc_pct_mean": round(float(
                (self.gc_hist * np.arange(101)).sum()
                / max(1, self.gc_hist.sum())), 3),
            "mean_phred": round(mean_q, 3),
            "duplicate_reads": self.n_dup,
            "duplicate_pct": round(100 * self.n_dup
                                   / max(1, self.n_reads), 3),
        }


def compute_readstats(records, kmer_len: int = 5,
                      track_dups: bool = True) -> ReadStats:
    st = ReadStats()
    keys = []
    kmer_acc = np.zeros(4 ** kmer_len, np.int64)
    pow4 = 4 ** np.arange(kmer_len - 1, -1, -1)
    for rec in records:
        c = rec.codes
        L = len(c)
        st.n_reads += 1
        st.n_bases += L
        st.max_len = max(st.max_len, L)
        st.len_dist[L] = st.len_dist.get(L, 0) + 1
        Lc = min(L, MAX_CYCLES)
        cb = np.minimum(c[:Lc], dna.BASE_N)
        np.add.at(st.cycle_base, (np.arange(Lc), cb), 1)
        if rec.qual is not None:
            q = np.clip(rec.qual[:Lc], 0, MAX_PHRED - 1)
            np.add.at(st.cycle_qual, (np.arange(Lc), q), 1)
        acgt = c[c < 4]
        if len(acgt):
            gc = int(round(100 * float(((acgt == 1) | (acgt == 2)).mean())))
            st.gc_hist[gc] += 1
        # K-mer spectrum over clean K-mers
        if L >= kmer_len:
            w = np.lib.stride_tricks.sliding_window_view(c, kmer_len)
            ok = (w < 4).all(axis=1)
            if ok.any():
                vals = (w[ok].astype(np.int64) * pow4).sum(axis=1)
                kmer_acc += np.bincount(vals, minlength=4 ** kmer_len)
        if track_dups:
            keys.append(c.tobytes())
    if track_dups and keys:
        seen: set = set()
        for k in keys:
            if k in seen:
                st.n_dup += 1
            else:
                seen.add(k)
    # keep the top spectrum sparsely
    nz = np.nonzero(kmer_acc)[0]
    st.kmer_counts = {int(v): int(kmer_acc[v]) for v in nz}
    return st


def write_readstats_csv(prefix, st: ReadStats, kmer_len: int = 5) -> None:
    """Distribution CSVs: <prefix>.cycles.csv, .quals.csv, .lens.csv,
    .kmers.csv + <prefix>.summary.json."""
    mx = st.max_len
    with open(f"{prefix}.cycles.csv", "w") as f:
        f.write('"cycle","A","C","G","T","N"\n')
        for i in range(min(mx, MAX_CYCLES)):
            row = st.cycle_base[i]
            f.write(f"{i+1}," + ",".join(str(int(x)) for x in row) + "\n")
    with open(f"{prefix}.quals.csv", "w") as f:
        f.write('"cycle","mean_phred","p25","p50","p75"\n')
        for i in range(min(mx, MAX_CYCLES)):
            h = st.cycle_qual[i]
            n = h.sum()
            if not n:
                continue
            cum = np.cumsum(h)
            mean = (h * np.arange(MAX_PHRED)).sum() / n
            pct = [int(np.searchsorted(cum, n * p)) for p in
                   (0.25, 0.5, 0.75)]
            f.write(f"{i+1},{mean:.2f},{pct[0]},{pct[1]},{pct[2]}\n")
    with open(f"{prefix}.lens.csv", "w") as f:
        f.write('"length","count"\n')
        for ln in sorted(st.len_dist):
            f.write(f"{ln},{st.len_dist[ln]}\n")
    with open(f"{prefix}.kmers.csv", "w") as f:
        f.write(f'"kmer","count"\n')
        for v, cnt in sorted(st.kmer_counts.items(),
                             key=lambda kv: -kv[1])[:4 ** kmer_len]:
            codes = [(v >> (2 * (kmer_len - 1 - j))) & 3
                     for j in range(kmer_len)]
            f.write(f'"{dna.decode(np.asarray(codes, np.uint8))}",{cnt}\n')
    with open(f"{prefix}.summary.json", "w") as f:
        json.dump(st.summary(), f, indent=2)
        f.write("\n")


def render_readstats_plots(prefix, st: ReadStats) -> list:
    """Render the reference's ngsqc plot set (ReadStats.cpp renders via
    libBKPLPlot; here matplotlib PNGs): per-cycle base composition,
    per-cycle Phred box profile, read-length distribution, GC%
    histogram. Returns the written paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    paths = []
    ncyc = int(np.nonzero(st.cycle_base.sum(axis=1))[0].max()) + 1 \
        if st.cycle_base.sum() else 0

    if ncyc:
        fig, ax = plt.subplots(figsize=(8, 4))
        tot = st.cycle_base[:ncyc].sum(axis=1, keepdims=True)
        frac = st.cycle_base[:ncyc] / np.maximum(tot, 1)
        for bi, name in enumerate("ACGTN"):
            ax.plot(np.arange(1, ncyc + 1), 100 * frac[:, bi],
                    label=name, linewidth=1)
        ax.set_xlabel("cycle")
        ax.set_ylabel("% of bases")
        ax.set_title("Per-cycle base composition")
        ax.legend(ncol=5, fontsize=8)
        p = f"{prefix}.cyclebases.png"
        fig.savefig(p, dpi=90)
        plt.close(fig)
        paths.append(p)

    if st.cycle_qual.sum():
        fig, ax = plt.subplots(figsize=(8, 4))
        cq = st.cycle_qual[:ncyc]
        phreds = np.arange(cq.shape[1])
        totq = cq.sum(axis=1)
        mean = (cq * phreds).sum(axis=1) / np.maximum(totq, 1)
        # quartiles from the cumulative distribution per cycle
        cum = cq.cumsum(axis=1)
        q25 = (cum >= (totq * 0.25)[:, None]).argmax(axis=1)
        q75 = (cum >= (totq * 0.75)[:, None]).argmax(axis=1)
        x = np.arange(1, ncyc + 1)
        ax.fill_between(x, q25, q75, alpha=0.3, label="IQR")
        ax.plot(x, mean, linewidth=1, label="mean")
        ax.set_xlabel("cycle")
        ax.set_ylabel("Phred")
        ax.set_title("Per-cycle quality")
        ax.legend(fontsize=8)
        p = f"{prefix}.cyclequal.png"
        fig.savefig(p, dpi=90)
        plt.close(fig)
        paths.append(p)

    if st.len_dist:
        fig, ax = plt.subplots(figsize=(6, 4))
        lens = sorted(st.len_dist)
        ax.bar(lens, [st.len_dist[x] for x in lens],
               width=max(1, (max(lens) - min(lens)) // 100))
        ax.set_xlabel("read length")
        ax.set_ylabel("reads")
        ax.set_title("Read length distribution")
        p = f"{prefix}.lengths.png"
        fig.savefig(p, dpi=90)
        plt.close(fig)
        paths.append(p)

    if st.gc_hist.sum():
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(np.arange(101), st.gc_hist, width=1)
        ax.set_xlabel("GC %")
        ax.set_ylabel("reads")
        ax.set_title("GC content distribution")
        p = f"{prefix}.gc.png"
        fig.savefig(p, dpi=90)
        plt.close(fig)
        paths.append(p)
    return paths


# --- contaminant-hit statistics (ProcNGSQC, ReadStats.cpp:2432;
#     CContaminants::MatchContaminants, libkit4b/Contaminants.h:226) ------

def contaminant_hits(reads: np.ndarray, adapters: dict | None = None, *,
                     min_overlap: int = 5, sub_rate: int = 1) -> dict:
    """Per-adapter contaminant overlay counts over a [N, L] code batch.

    Matching follows the reference rules (Contaminants.h:226-230 via
    ReadStats.cpp:1153-1159): a 3' overlay is a read tail matching a
    contaminant PREFIX, a 5' overlay a read head matching a contaminant
    SUFFIX; overlaps >= min_overlap (default 5) accepted with sub_rate
    substitutions allowed per 25 bp of overlap (min 1 when rate > 0) and
    ZERO substitutions in the first 15 bp of the overlap.

    Returns {adapter: {"hits3": n, "hits5": n}}; a read counts once per
    (adapter, side) at its longest accepted overlap."""
    from ..assembly.contaminants import DEFAULT_ADAPTERS
    from .. import dna as _dna
    adapters = adapters or DEFAULT_ADAPTERS
    N, L = reads.shape
    out = {}
    for name, seq in adapters.items():
        ad = _dna.encode(seq) if isinstance(seq, str) else \
            np.asarray(seq, np.uint8)
        A = len(ad)
        hit3 = np.zeros(N, bool)
        hit5 = np.zeros(N, bool)
        for o in range(min(L, A), min_overlap - 1, -1):
            allow = max(1, sub_rate * o // 25) if sub_rate else 0
            exact = min(15, o)
            # 3': read[-o:] vs adapter[:o]
            t = reads[:, L - o:]
            mm = (t != ad[:o]).sum(axis=1)
            mm_head = (t[:, :exact] != ad[:exact]).sum(axis=1)
            hit3 |= (~hit3) & (mm <= allow) & (mm_head == 0)
            # 5': read[:o] vs adapter[-o:]
            h = reads[:, :o]
            mm = (h != ad[A - o:]).sum(axis=1)
            mm_head = (h[:, :exact] != ad[A - o:A - o + exact]).sum(axis=1)
            hit5 |= (~hit5) & (mm <= allow) & (mm_head == 0)
        out[name] = {"hits3": int(hit3.sum()), "hits5": int(hit5.sum()),
                     "_mask": hit3 | hit5}
    return out


def compute_contaminant_stats(records, adapters: dict | None = None, *,
                              min_overlap: int = 5,
                              sub_rate: int = 1) -> dict:
    """Stream records -> contaminant stat dict: per-adapter 5'/3' overlay
    counts plus the number of distinct contaminated reads (the reference's
    'reads checked / reads with contaminant overlays' NGSQC numbers)."""
    from collections import defaultdict
    per: dict = defaultdict(lambda: {"hits3": 0, "hits5": 0})
    n_reads = 0
    n_contam = 0
    buckets: dict[int, list] = defaultdict(list)
    for rec in records:
        buckets[len(rec.codes)].append(rec.codes)

    for L, codes in buckets.items():
        reads = np.stack(codes)
        n_reads += len(reads)
        res = contaminant_hits(reads, adapters, min_overlap=min_overlap,
                               sub_rate=sub_rate)
        any_mask = np.zeros(len(reads), bool)
        for name, st in res.items():
            per[name]["hits3"] += st["hits3"]
            per[name]["hits5"] += st["hits5"]
            any_mask |= st["_mask"]
        n_contam += int(any_mask.sum())
    return {"reads": n_reads, "contaminated_reads": n_contam,
            "per_adapter": {k: dict(v) for k, v in per.items()}}


def write_contaminant_csv(path, st: dict) -> None:
    with open(path, "w") as f:
        f.write('"Contaminant","Hits5","Hits3"\n')
        for name, v in st["per_adapter"].items():
            f.write(f'"{name}",{v["hits5"]},{v["hits3"]}\n')
        f.write(f'"TOTAL_READS",{st["reads"]},\n')
        f.write(f'"CONTAMINATED_READS",{st["contaminated_reads"]},\n')
