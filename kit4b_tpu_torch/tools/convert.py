"""Standalone converter/utility tools, the port's copy of
kit4b_tpu/tools/convert.py (host only; tests/test_torch_rehomed.py holds
it equal to the original statement for statement): bed2csv, csv2bed,
csv2fasta, splitmultifasta, quickcount (N-mer distributions),
Loci2Phylip, genGenomeFromAGP, filterreads/ufilter (loci filtering),
genNormWiggle, usimdiffexpr (simulated DE counts).

Loci CSV rows follow the reference's 8-field element convention: SrcID,
ElType, Species, Chrom, StartLoci, EndLoci, Len, Strand.
"""
from __future__ import annotations

import csv
from collections import defaultdict

import numpy as np

from .. import dna


def read_loci_csv(path) -> list[dict]:
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < 7:
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
                "strand": row[7].strip().strip('"')
                if len(row) > 7 else "+"})
    return out


def write_loci_csv(path, loci: list[dict]) -> None:
    with open(path, "w") as f:
        for e in loci:
            f.write(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                    f'"{e["chrom"]}",{e["start"]},{e["end"]},'
                    f'{e["len"]},"{e["strand"]}"\n')


def bed2csv(bed_path, csv_path, el_type: str = "element",
            species: str = "") -> int:
    from ..io.bed import BedFile
    bed = BedFile.load(bed_path)
    loci = []
    for i, ft in enumerate(bed.features):
        loci.append({"srcid": i + 1, "type": el_type,
                     "species": species, "chrom": ft.chrom,
                     "start": ft.start, "end": ft.end - 1,
                     "len": ft.end - ft.start,
                     "strand": ft.strand or "+"})
    write_loci_csv(csv_path, loci)
    return len(loci)


def csv2bed(csv_path, bed_path) -> int:
    loci = read_loci_csv(csv_path)
    with open(bed_path, "w") as f:
        for e in loci:
            name = f'{e["type"]}{e["srcid"]}'
            f.write(f'{e["chrom"]}\t{e["start"]}\t{e["end"] + 1}\t'
                    f'{name}\t0\t{e["strand"]}\n')
    return len(loci)


def csv2fasta(csv_path, genome, out_path) -> int:
    """Extract element sequences at loci CSV coords from the genome."""
    from ..io.fasta import SeqRecord, write_fasta
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    recs = []
    for e in read_loci_csv(csv_path):
        if e["chrom"] not in starts:
            continue
        s0 = starts[e["chrom"]]
        a = max(0, e["start"])
        b = min(lens[e["chrom"]], e["end"] + 1)
        codes = genome.seq[s0 + a:s0 + b]
        if e["strand"] == "-":
            codes = dna.revcomp(codes)
        recs.append(SeqRecord(
            f'{e["type"]}{e["srcid"]}',
            f'{e["chrom"]}:{a}-{b}({e["strand"]})', codes))
    write_fasta(out_path, recs)
    return len(recs)


def split_multifasta(in_path, out_dir, max_per_file: int = 1) -> int:
    """splitmultifasta: one output file per max_per_file sequences."""
    import os
    from ..io.fasta import read_seqs, write_fasta
    os.makedirs(out_dir, exist_ok=True)
    batch, n_files, n = [], 0, 0
    for rec in read_seqs(in_path):
        batch.append(rec)
        n += 1
        if len(batch) >= max_per_file:
            name = batch[0].name.replace("/", "_") if \
                max_per_file == 1 else f"part{n_files + 1}"
            write_fasta(os.path.join(out_dir, f"{name}.fa"), batch)
            batch, n_files = [], n_files + 1
    if batch:
        name = batch[0].name.replace("/", "_") if max_per_file == 1 \
            else f"part{n_files + 1}"
        write_fasta(os.path.join(out_dir, f"{name}.fa"), batch)
        n_files += 1
    return n_files


def quickcount(records, min_k: int = 1, max_k: int = 5,
               per_seq: bool = False):
    """quickcount: N-mer occurrence distributions for k in
    [min_k, max_k]. Returns {k: {mer: count}} (or per-seq dict).
    Counting is a vectorized base-4 rolling index per k."""
    def count_one(codes):
        out = {}
        c = np.asarray(codes, np.int64)
        valid = c <= 3
        for k in range(min_k, max_k + 1):
            if len(c) < k:
                out[k] = {}
                continue
            win = np.lib.stride_tricks.sliding_window_view(c, k)
            vok = np.lib.stride_tricks.sliding_window_view(
                valid, k).all(axis=1)
            pw = 4 ** np.arange(k - 1, -1, -1)
            idx = (win[vok] @ pw)
            cnt = np.bincount(idx, minlength=4 ** k)
            nz = np.nonzero(cnt)[0]
            out[k] = {_mer(i, k): int(cnt[i]) for i in nz}
        return out

    if per_seq:
        return {rec.name: count_one(rec.codes) for rec in records}
    tot: dict = {k: defaultdict(int) for k in range(min_k, max_k + 1)}
    for rec in records:
        for k, d in count_one(rec.codes).items():
            for mer, n in d.items():
                tot[k][mer] += n
    return {k: dict(d) for k, d in tot.items()}


def _mer(idx: int, k: int) -> str:
    s = []
    for _ in range(k):
        s.append("ACGT"[idx & 3])
        idx >>= 2
    return "".join(reversed(s))


def write_quickcount_csv(path, counts: dict) -> None:
    with open(path, "w") as f:
        f.write('"K","NMer","Count","Freq"\n')
        for k in sorted(counts):
            tot = sum(counts[k].values()) or 1
            for mer in sorted(counts[k]):
                n = counts[k][mer]
                f.write(f'{k},"{mer}",{n},{n / tot:.6f}\n')


def gen_genome_from_agp(agp_path, contigs: dict, out_path) -> int:
    """genGenomeFromAGP mode 0: assemble chromosome fasta from AGP
    placement lines (object, obj_beg, obj_end, part#, type, ...;
    type N/U = gap of given length, else component_id orientation)."""
    from ..io.fasta import SeqRecord, write_fasta
    chroms: dict[str, list] = {}
    order: list[str] = []
    with open(agp_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 6:
                continue
            obj, beg = t[0], int(t[1])
            if obj not in chroms:
                chroms[obj] = []
                order.append(obj)
            if t[4] in ("N", "U"):
                chroms[obj].append(np.full(int(t[5]), 4, np.uint8))
            else:
                comp, orient = t[5], (t[8] if len(t) > 8 else "+")
                if comp not in contigs:
                    raise ValueError(f"AGP component '{comp}' not in "
                                     f"contig fasta")
                cbeg, cend = int(t[6]), int(t[7])
                codes = contigs[comp][cbeg - 1:cend]
                if orient == "-":
                    codes = dna.revcomp(codes)
                chroms[obj].append(codes)
    recs = [SeqRecord(o, "", np.concatenate(chroms[o]))
            for o in order]
    write_fasta(out_path, recs)
    return len(recs)


def filter_loci(loci: list[dict], *, strand: str | None = None,
                chrom_include: list | None = None,
                chrom_exclude: list | None = None,
                min_len: int = 0, trunc_len: int = 0,
                ofs: int = 0, delta_len: int = 0) -> list[dict]:
    """filterreads/ufilter loci filtering: strand/chrom selection,
    minimum length, truncation, loci offset and length delta."""
    import re
    inc = [re.compile(p) for p in (chrom_include or [])]
    exc = [re.compile(p) for p in (chrom_exclude or [])]
    out = []
    for e in loci:
        if strand and e["strand"] != strand:
            continue
        if inc and not any(p.search(e["chrom"]) for p in inc):
            continue
        if exc and any(p.search(e["chrom"]) for p in exc):
            continue
        start = max(0, e["start"] + ofs)
        end = e["end"] + ofs + delta_len
        if trunc_len and end - start + 1 > trunc_len:
            end = start + trunc_len - 1
        if end - start + 1 < max(min_len, 1):
            continue
        ne = dict(e)
        ne["start"], ne["end"] = start, end
        ne["len"] = end - start + 1
        out.append(ne)
    return out


def sim_diff_expr(n_transcripts: int = 1000, n_reps: int = 2,
                  total_counts: int = 50_000_000,
                  de_pct: int = 0, vary_counts_pct: int = 10,
                  mode: int = 0, seed: int = 1):
    """usimdiffexpr: simulate a transcript x (control/expr x reps)
    counts matrix. mode 0 uniform, 1 linear-random, 2 power-law
    expression profile; de_pct% of transcripts get 2-8x differential
    expression in the experiment group."""
    rng = np.random.default_rng(seed)
    if mode == 0:
        base = np.full(n_transcripts, 1.0)
    elif mode == 1:
        base = rng.random(n_transcripts) + 1e-3
    else:
        base = 1.0 / (np.arange(1, n_transcripts + 1) ** 0.8)
    base /= base.sum()
    de = np.ones(n_transcripts)
    n_de = n_transcripts * de_pct // 100
    de_idx = rng.choice(n_transcripts, n_de, replace=False)
    de[de_idx] = rng.uniform(2.0, 8.0, n_de) ** \
        rng.choice([-1.0, 1.0], n_de)
    cols = {}
    for grp, scale in (("Ctrl", np.ones(n_transcripts)), ("Expr", de)):
        p = base * scale
        p /= p.sum()
        for r in range(n_reps):
            tot = int(total_counts *
                      (1 + rng.uniform(-vary_counts_pct,
                                       vary_counts_pct) / 100.0))
            cols[f"{grp}Rep{r + 1}"] = rng.multinomial(tot, p)
    return cols, de_idx


def write_sim_counts(path, cols: dict, sep: str = ",") -> None:
    names = list(cols)
    n = len(next(iter(cols.values())))
    with open(path, "w") as f:
        f.write(sep.join(['"Transcript"'] + [f'"{c}"' for c in names])
                + "\n")
        for i in range(n):
            f.write(sep.join([f'"T{i + 1}"']
                             + [str(int(cols[c][i])) for c in names])
                    + "\n")


def loci_to_phylip(malign, loci: list[dict], out_path,
                   concat: bool = True) -> int:
    """Loci2Phylip: extract multialignment columns at each locus and
    write relaxed sequential Phylip (concatenated across loci)."""
    parts: dict[str, list] = {sp: [] for sp in malign.species}
    n_used = 0
    for e in loci:
        for blk in malign.blocks:
            if blk.ref_chrom != e["chrom"]:
                continue
            ref = blk.rows[0]
            ref_pos = np.cumsum(ref != dna.BASE_INDEL) - 1 \
                + blk.ref_start
            sel = (ref_pos >= e["start"]) & (ref_pos <= e["end"]) \
                & (ref != dna.BASE_INDEL)
            if not sel.any():
                continue
            n_used += 1
            present = set(blk.species)
            for sp in malign.species:
                if sp in present:
                    row = blk.rows[blk.species.index(sp)][sel]
                    parts[sp].append(_codes_to_align_str(row))
                else:
                    parts[sp].append("-" * int(sel.sum()))
    seqs = {sp: "".join(p) for sp, p in parts.items() if p}
    if not seqs:
        return 0
    ln = len(next(iter(seqs.values())))
    with open(out_path, "w") as f:
        f.write(f" {len(seqs)} {ln}\n")
        for sp, s in seqs.items():
            f.write(f"{sp[:32]:<34}{s}\n")
    return n_used


def _codes_to_align_str(codes: np.ndarray) -> str:
    out = []
    for c in codes:
        if c == dna.BASE_INDEL:
            out.append("-")
        elif c > 3:
            out.append("N")
        else:
            out.append("ACGT"[c])
    return "".join(out)
