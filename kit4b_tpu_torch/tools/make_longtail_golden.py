"""The seeded workload of the long-tail golden file and the arrays it holds:
`blitz` (gapped and `--no-gapped`), `hrdx`, `kmerdist`, `benchmark` in
modes 0-4, `alignsbs`, `ngsqc -H -`, `maploci` and `rnade`, each through
the command line.

`kit4b_tpu_torch/data/longtail_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_longtail_golden.py` regenerates
it (JAX on the CPU; the big blitz set takes minutes). A machine without
JAX rebuilds the same inputs with `workload()` (numpy and the port's own
host modules), runs the port with `compute(port_fns(device), work)` and
compares with `differing()`: that is how the port is held to the JAX
package on the card.

The workload (`workload()`):

- blitz's small set on tests/test_blitz.py's 300 kbp genome (seed 91):
  that file's queries (exact, 2 % and 1 % reverse-complemented, the random
  500 bp query with no chain, the PSL query, the 40 bp and 30 bp
  deletions) and edge cases: a 30 bp insertion, a query whose two halves
  land on opposite strands, the genome's last 1,000 bp with 10 bp inserted
  at 900 (a chain whose t1 passes the end of the genome, dropped), a query
  of 8 bp (under the index's lut_k of 10), and queries of exactly 2,048 bp
  and 2,049 bp (a multiple of 512 and one past it);
- blitz's big set: BIG_QUERIES seeded queries of 1-16 kbp from a 1 Mbp
  genome of three chromosomes (1 % substitutions, a 10-40 bp deletion in
  half and an insertion in a quarter, half reverse-complemented) and
  BIG_RANDOM random ones;
- hrdx: two 24 kbp haplotypes (B = A with 0.5 % substitutions), each cut
  at its own breakpoints into contigs of 2-6 kbp, three haplotype-unique
  contigs and one of 80 bp (under -L);
- kmerdist: a MAF written from the small set's gapped PSL (`maf_text`),
  at -K 16 and -K 5;
- benchmark: tests/test_magicbench.py's 30 kbp genome, SE and PE control
  SAMs with clips and InDels (mode 1), the profiles replayed (mode 2, SE and
  PE), the replayed reads scored from a SAM built from their descriptors
  with some moved (mode 3), a FASTQ cut to 20 reads (mode 0) and a SAM of
  simreads-named records (mode 4, -t 0 and -t 5);
- alignsbs: tests/test_longtail2.py's assembly (20 kbp, seed 9), queries
  and targets, -b 3 -r 4, and -b 2 -r 7 -a -s 2;
- ngsqc: 200 reads of 60-100 bp with qualities, adapters at either end, Ns
  and a duplicate, with -H - and with a contaminant FASTA;
- maploci: the control SAM against named and unnamed BED features;
- rnade: six BED12 genes, control and experiment SAMs, at -r 1 and at
  -r 0 -c 5 -n 1.0 -A -s 1 -x with an exclusion CSV.

The file holds each command's output files' bytes (`cli:<run>:<file>`),
the printed JSON where a command prints it (`stdout:<run>`) and the
SHA-256 of the inputs.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..io.fasta import SeqRecord, write_fasta, write_fastq

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "longtail_golden.npz"
SEED = 1414
BLITZ_LEN = 300_000            # tests/test_blitz.py's genome, seed 91
BIG_CHROMS = (("bc1", 450_000), ("bc2", 350_000), ("bc3", 200_000))
BIG_QUERIES, BIG_RANDOM = 190, 10
BIG_LEN = (1_000, 16_000)
# the commands, in order: name -> argv, with {d} the working directory; the
# port adds --device to DEVICE_CMDS. "big" runs only where `big` is asked.
RUNS = {
    "index_small": ["index", "-i", "{d}/blitz_g.fa", "-o", "{d}/small.kix"],
    "blitz_small_gapped": ["blitz", "-i", "{d}/small_q.fa", "-I",
                           "{d}/small.kix", "-o", "{d}/small_gapped.psl"],
    "blitz_small_ungapped": ["blitz", "--no-gapped", "-i", "{d}/small_q.fa",
                             "-I", "{d}/small.kix", "-o",
                             "{d}/small_ungapped.psl"],
    "blitz_small_opts": ["blitz", "--no-gapped", "-i", "{d}/small_q.fa",
                         "-I", "{d}/small.kix", "-o", "{d}/small_opts.psl",
                         "-s", "2", "-c", "5", "-b", "20", "-m", "200"],
    "hrdx": ["hrdx", "-i", "{d}/diploid.fa", "-o", "{d}/reduced.fa"],
    "hrdx_opts": ["hrdx", "-i", "{d}/diploid.fa", "-o", "{d}/reduced2.fa",
                  "-z", "1", "-Z", "150", "-k", "10", "-L", "2500"],
    "kmerdist": ["kmerdist", "-i", "{d}/hits.maf", "-o", "{d}/kd16.csv"],
    "kmerdist_k5": ["kmerdist", "-i", "{d}/hits.maf", "-o", "{d}/kd5.csv",
                    "-K", "5"],
    "bench_m0": ["benchmark", "-m", "0", "-i", "{d}/raw.fq", "-o",
                 "{d}/limited.fq", "--maxreads", "20"],
    "bench_m1": ["benchmark", "-m", "1", "-i", "{d}/ctrl.sam",
                 "--refgenome", "{d}/bench_g.fa", "--cigarsfile",
                 "{d}/obs.csv"],
    "bench_m2": ["benchmark", "-m", "2", "--cigarsfile", "{d}/obs.csv",
                 "--refgenome", "{d}/bench_g.fa", "-o", "{d}/sim.fa",
                 "--maxreads", "50", "--seed", "3"],
    "bench_m3": ["benchmark", "-m", "3", "-i", "{d}/sim.sam",
                 "--groundtruth", "{d}/sim.fa", "-o", "{d}/score.json"],
    "bench_m1_pe": ["benchmark", "-m", "1", "--pe", "-i", "{d}/ctrl_pe.sam",
                    "--refgenome", "{d}/bench_g.fa", "--cigarsfile",
                    "{d}/obs_pe.csv"],
    "bench_m2_pe": ["benchmark", "-m", "2", "--cigarsfile",
                    "{d}/obs_pe.csv", "--refgenome", "{d}/bench_g.fa", "-o",
                    "{d}/sim1.fa", "--outpe2", "{d}/sim2.fa", "--maxreads",
                    "30", "--seed", "5"],
    "bench_m3_pe": ["benchmark", "-m", "3", "--pe", "-i", "{d}/sim_pe.sam",
                    "--groundtruth", "{d}/sim1.fa", "--outpe2",
                    "{d}/sim2.fa", "-o", "{d}/score_pe.json", "-j", "0.5",
                    "-J", "2"],
    "bench_m4": ["benchmark", "-i", "{d}/truth.sam", "-o",
                 "{d}/bench4.json"],
    "bench_m4_t5": ["benchmark", "-m", "4", "-i", "{d}/truth.sam", "-t",
                    "5"],
    "alignsbs": ["alignsbs", "-p", "{d}/sbs_q.fa", "-P", "{d}/sbs_asm.fa",
                 "-i", "{d}/sbs_t.fa", "-I", "{d}/sbs_asm.fa", "-b", "3",
                 "-r", "4", "-o", "{d}/sbs_q.csv", "-O", "{d}/sbs_t.csv"],
    "alignsbs_opts": ["alignsbs", "-p", "{d}/sbs_q.fa", "-P",
                      "{d}/sbs_asm.fa", "-i", "{d}/sbs_t.fa", "-I",
                      "{d}/sbs_asm.fa", "-b", "2", "-r", "7", "-a", "-s",
                      "2", "-o", "{d}/sbs_q2.csv", "-O", "{d}/sbs_t2.csv"],
    "ngsqc": ["ngsqc", "-i", "{d}/qc.fq", "-o", "{d}/qc", "-H", "-"],
    "ngsqc_custom": ["ngsqc", "-i", "{d}/qc.fq", "{d}/raw.fq", "-o",
                     "{d}/qc2", "-K", "3", "-H", "{d}/contam.fa", "-z", "2",
                     "-Z", "8"],
    "maploci": ["maploci", "-i", "{d}/ctrl.sam", "-b", "{d}/feats.bed",
                "-o", "{d}/maploci.csv"],
    "rnade": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam", "-g",
              "{d}/genes.bed", "-o", "{d}/de.csv", "-O", "{d}/bins.csv"],
    "rnade_opts": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam",
                   "-g", "{d}/genes.bed", "-o", "{d}/de2.csv", "-r", "0",
                   "-c", "5", "-n", "1.0", "-A", "-s", "1", "-x",
                   "{d}/zones.csv", "-b", "8"],
    "index_big": ["index", "-i", "{d}/big_g.fa", "-o", "{d}/big.kix"],
    "blitz_big_gapped": ["blitz", "-i", "{d}/big_q.fa", "-I", "{d}/big.kix",
                         "-o", "{d}/big_gapped.psl"],
    "blitz_big_ungapped": ["blitz", "--no-gapped", "-i", "{d}/big_q.fa",
                           "-I", "{d}/big.kix", "-o",
                           "{d}/big_ungapped.psl"],
}
DEVICE_CMDS = ("blitz", "alignsbs")
BIG_RUNS = ("index_big", "blitz_big_gapped", "blitz_big_ungapped")


def _mutate_subs(rng, codes, rate):
    out = codes.copy()
    n = int(len(out) * rate)
    if n:
        at = rng.choice(len(out), n, replace=False)
        out[at] = (out[at] + 1 + rng.integers(0, 3, n)) % 4
    return out


def blitz_small():
    """tests/test_blitz.py's genome codes (BLITZ_LEN bases) and the small
    query set as (name, codes)."""
    rng = np.random.default_rng(91)
    g = rng.integers(0, 4, BLITZ_LEN).astype(np.uint8)
    qs = []
    qrng = np.random.default_rng(3)     # test_blitz_exact_and_divergent
    for i, (start, ln, div, rev) in enumerate(
            [(5_000, 2_000, 0.0, False), (50_000, 5_000, 0.02, False),
             (120_000, 3_000, 0.01, True)]):
        q = g[start:start + ln].copy()
        nmut = int(ln * div)
        if nmut:
            idx = qrng.choice(ln, nmut, replace=False)
            q[idx] = (q[idx] + 1) % 4
        if rev:
            q = dna.revcomp(q)
        qs.append((f"q{i}", q))
    qs.append(("rand", np.random.default_rng(4).integers(0, 4, 500)
               .astype(np.uint8)))
    qs.append(("qq", g[1000:3000].copy()))
    t = g[200_000:203_000]
    qs.append(("gq", np.concatenate([t[:1500], t[1540:]])))
    t = g[10_000:12_000]
    qs.append(("gq30", np.concatenate([t[:1000], t[1030:]])))
    rng = np.random.default_rng(SEED)
    t = g[60_000:62_500]
    qs.append(("ins30", np.concatenate(
        [t[:1200], rng.integers(0, 4, 30).astype(np.uint8), t[1200:]])))
    qs.append(("both", np.concatenate(
        [g[150_000:151_200], dna.revcomp(g[250_000:251_300])])))
    t = g[BLITZ_LEN - 1_000:]
    qs.append(("end", np.concatenate(
        [t[:900], rng.integers(0, 4, 10).astype(np.uint8), t[900:]])))
    qs.append(("short", g[7_000:7_008].copy()))
    qs.append(("len2048", _mutate_subs(rng, g[80_000:82_048], 0.01)))
    qs.append(("len2049", _mutate_subs(rng, g[90_000:92_049], 0.01)))
    return g, qs


def planted_queries(rng, chroms, n, n_random, lens, sub=0.01,
                    indel=(10, 40)):
    """`n` queries of lengths uniform in `lens` drawn from `chroms` [(name,
    codes)] (chromosome by length), with `sub` substitutions; queries
    i % 2 == 0 lose one `indel`-long stretch, i % 4 == 1 gain one, and half
    (by a draw) are reverse-complemented; then `n_random` random 2 kbp
    queries. Names carry the truth: `p<i>|<chrom>|<start>|<span>|<strand>|
    <del>|<ins>` (span: the genome bases covered), `r<i>` for the random
    ones. Returns [(name, codes)]."""
    sizes = np.array([len(c) for _, c in chroms], np.float64)
    out = []
    for i in range(n):
        ci = int(rng.choice(len(chroms), p=sizes / sizes.sum()))
        name, codes = chroms[ci]
        ln = int(rng.integers(lens[0], lens[1] + 1))
        d = int(rng.integers(indel[0], indel[1] + 1)) if i % 2 == 0 else 0
        span = ln + d
        start = int(rng.integers(0, len(codes) - span))
        q = _mutate_subs(rng, codes[start:start + span], sub)
        ins = 0
        if d:
            at = int(rng.integers(span // 4, 3 * span // 4))
            q = np.concatenate([q[:at], q[at + d:]])
        elif i % 4 == 1:
            ins = int(rng.integers(indel[0], indel[1] + 1))
            at = int(rng.integers(ln // 4, 3 * ln // 4))
            q = np.concatenate([q[:at], rng.integers(0, 4, ins)
                                .astype(np.uint8), q[at:]])
        strand = "-" if rng.random() < 0.5 else "+"
        if strand == "-":
            q = dna.revcomp(q)
        out.append((f"p{i}|{name}|{start}|{span}|{strand}|{d}|{ins}", q))
    for i in range(n_random):
        out.append((f"r{i}", rng.integers(0, 4, 2_000).astype(np.uint8)))
    return out


def blitz_big():
    """The big set's genome [(name, codes)] and queries."""
    rng = np.random.default_rng(SEED + 1)
    chroms = [(n, rng.integers(0, 4, ln).astype(np.uint8))
              for n, ln in BIG_CHROMS]
    return chroms, planted_queries(rng, chroms, BIG_QUERIES, BIG_RANDOM,
                                   BIG_LEN)


def diploid_contigs(rng, hap_len, ctg_len, n_unique, unique_len,
                    het=0.005):
    """Haplotype A (`hap_len` random bases) and B = A with `het`
    substitutions, each cut at its own seeded breakpoints into contigs of
    `ctg_len` (min, max) bases; plus `n_unique` contigs of `unique_len`
    bases found in neither. Returns [(name, codes)] (A's, B's, then the
    unique ones named `u<i>`) and hap_len."""
    a = rng.integers(0, 4, hap_len).astype(np.uint8)
    b = _mutate_subs(rng, a, het)
    out = []
    for tag, h in (("A", a), ("B", b)):
        pos, i = 0, 0
        while pos < hap_len:
            ln = int(rng.integers(ctg_len[0], ctg_len[1] + 1))
            out.append((f"{tag}{i}", h[pos:pos + ln].copy()))
            pos += ln
            i += 1
    for i in range(n_unique):
        out.append((f"u{i}", rng.integers(0, 4, unique_len)
                    .astype(np.uint8)))
    return out


def psl_rows(text: str) -> list[list[str]]:
    """The hit rows of a PSL file written by `write_psl`, split on tabs."""
    return [r.split("\t") for r in text.splitlines()[5:] if r]


def _blocks(row):
    return zip(*([int(x) for x in row[c].rstrip(",").split(",")]
                 for c in (19, 20, 18)))


def maf_text(psl: str, genome: dict, queries: dict) -> str:
    """A pairwise MAF of blitz's PSL hits: for each, the target row
    (`ref.<chrom>`) and the query row (its strand's codes) through the
    hit's blocks, '-' where the other row has bases between two blocks;
    the block's score is the hit's matches."""
    lines = ["##maf version=1"]
    for r in psl_rows(psl):
        chrom, qname, strand = r[13], r[9], r[8]
        t = genome[chrom]
        q = queries[qname]
        if strand == "-":
            q = dna.revcomp(q)
        trow, qrow = [], []
        prev = None
        for qb, tb, ln in _blocks(r):
            if prev is not None:
                tgap, qgap = t[prev[1]:tb], q[prev[0]:qb]
                trow.append(dna.decode(tgap) + "-" * len(qgap))
                qrow.append("-" * len(tgap) + dna.decode(qgap))
            trow.append(dna.decode(t[tb:tb + ln]))
            qrow.append(dna.decode(q[qb:qb + ln]))
            prev = (qb + ln, tb + ln)
        t0, t1, q0, q1 = int(r[15]), int(r[16]), int(r[11]), int(r[12])
        lines += [f"a score={r[0]}",
                  f"s ref.{chrom} {t0} {t1 - t0} + {len(t)} "
                  f"{''.join(trow)}",
                  f"s {qname} {q0} {q1 - q0} {strand} {len(q)} "
                  f"{''.join(qrow)}", ""]
    return "\n".join(lines) + "\n"


def kmer_runs(psl: str, genome: dict, queries: dict, max_k: int) -> dict:
    """kmerdist's counts computed straight from the hits: the columns of
    each hit's blocks, a match where both bases are equal A/C/G/T, and the
    gap columns between blocks breaking the runs; counts[k] is the sum
    over runs of max(0, run - k + 1)."""
    counts = np.zeros(max_k + 1, np.int64)
    npos = nblk = 0
    for r in psl_rows(psl):
        t, q = genome[r[13]], queries[r[9]]
        if r[8] == "-":
            q = dna.revcomp(q)
        cols = []
        prev = None
        for qb, tb, ln in _blocks(r):
            if prev is not None:
                cols.append(np.zeros((tb - prev[1]) + (qb - prev[0]), bool))
            a, b = q[qb:qb + ln], t[tb:tb + ln]
            cols.append((a == b) & (a < 4) & (b < 4))
            prev = (qb + ln, tb + ln)
        m = np.concatenate(cols)
        nblk += 1
        npos += len(m)
        edge = np.diff(np.concatenate([[0], m.astype(np.int8), [0]]))
        runs = np.nonzero(edge == -1)[0] - np.nonzero(edge == 1)[0]
        for k in range(1, max_k + 1):
            counts[k] += int(np.maximum(runs - k + 1, 0).sum())
    return {"counts": counts.tolist(), "positions": npos, "blocks": nblk}


def _sam(path, chroms, rows):
    """A SAM of (qname, flag, rname, pos1, cigar, seq[, tlen]) rows."""
    with open(path, "w") as f:
        f.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in chroms:
            f.write(f"@SQ\tSN:{name}\tLN:{ln}\n")
        for r in rows:
            qname, flag, rname, pos1, cigar, seq = r[:6]
            tlen = r[6] if len(r) > 6 else 0
            f.write(f"{qname}\t{flag}\t{rname}\t{pos1}\t60\t{cigar}\t*\t0\t"
                    f"{tlen}\t{seq}\t*\n")


def _bench_inputs(rng):
    """tests/test_magicbench.py's genome and this workload's control SAMs
    (SE: 60 clean reads as that file's CLI test draws them, then reads
    with an edge soft clip, an insertion, a deletion and a reverse strand;
    PE: 24 pairs), a FASTQ and a SAM of simreads-named records."""
    g = np.random.default_rng(11).integers(0, 4, 30_000).astype(np.uint8)
    rows = []
    r5 = np.random.default_rng(5)
    for i in range(60):
        pos = int(r5.integers(0, 20_000))
        codes = g[pos:pos + 50].copy()
        if i % 3 == 0:
            codes[25] = (codes[25] + 1) & 3
        rows.append((f"c{i}", 0, "chrT", pos + 1, "50M", dna.decode(codes)))
    for i in range(12):
        pos = int(rng.integers(100, 25_000))
        kind = i % 4
        if kind == 0:          # 5 bp soft clip folded into the first M
            rows.append((f"s{i}", 0, "chrT", pos + 6, "5S45M",
                         dna.decode(g[pos + 1:pos + 51])))
        elif kind == 1:        # 2 bp insertion
            codes = np.concatenate([g[pos:pos + 20], [0, 1],
                                    g[pos + 20:pos + 48]])
            rows.append((f"s{i}", 0, "chrT", pos + 1, "20M2I28M",
                         dna.decode(codes)))
        elif kind == 2:        # 3 bp deletion
            codes = np.concatenate([g[pos:pos + 25], g[pos + 28:pos + 53]])
            rows.append((f"s{i}", 0, "chrT", pos + 1, "25M3D25M",
                         dna.decode(codes)))
        else:
            codes = g[pos:pos + 50].copy()
            codes[10] = (codes[10] + 2) & 3
            rows.append((f"s{i}", 16, "chrT", pos + 1, "50M",
                         dna.decode(codes)))
    pe = []
    for i in range(24):
        pos = int(rng.integers(0, 29_000 - 300))
        ins = int(rng.integers(150, 300))
        c1 = g[pos:pos + 50].copy()
        c2 = g[pos + ins - 50:pos + ins].copy()
        if i % 2:
            c1[int(rng.integers(0, 50))] ^= 1
        pe.append((f"pp{i}", 0x41 | 0x20, "chrT", pos + 1, "50M",
                   dna.decode(c1), ins))
        pe.append((f"pp{i}", 0x81 | 0x10, "chrT", pos + ins - 49, "50M",
                   dna.decode(c2), -ins))
    raw = [SeqRecord(f"raw{i}", "", rng.integers(0, 4, 40).astype(np.uint8),
                     rng.integers(2, 41, 40).astype(np.uint8))
           for i in range(30)]

    def truth(i, start, ln, strand):
        return f"lcl|{i:08d}|chrT|{start}|{start + ln - 1}|{ln}|{strand}|0|0"
    t_rows = [(truth(1, 100, 100, "+"), 0, "chrT", 101, "100M", "A" * 100),
              (truth(2, 300, 100, "-"), 16, "chrT", 301, "100M", "A" * 100),
              (truth(3, 500, 100, "+"), 0, "chrT", 901, "100M", "A" * 100),
              (truth(4, 700, 100, "+"), 16, "chrT", 701, "100M", "A" * 100),
              (truth(5, 900, 100, "+"), 4, "*", 0, "*", "A" * 100),
              (truth(6, 1100, 100, "+"), 0, "chrT", 1103, "100M", "A" * 100),
              (truth(6, 1100, 100, "+"), 0x100, "chrT", 5000, "100M", "*"),
              (truth(7, 1300, 100, "+"), 0x41, "chrT", 1301, "100M", "A" * 100),
              (truth(7, 1300, 100, "+"), 0x81, "chrT", 1501, "100M", "A" * 100),
              ("notruth", 0, "chrT", 50, "100M", "A" * 100),
              (truth(1, 100, 100, "+"), 0, "chrT", 101, "100M", "A" * 100)]
    return g, rows, pe, raw, t_rows


def sim_sam_rows(records, shift_every=7, pe2=False):
    """SAM rows placing replayed reads (benchmark mode 2's FASTA records)
    at their descriptor's truth, with the read's CIGAR ('='/'X' as M);
    every `shift_every`-th read moved 1,000 bp (none for 0)."""
    from ..align import magicbench as mb
    rows = []
    for i, rec in enumerate(records):
        parts = rec.descr.split()
        start1, strand, cig = int(parts[3]), parts[4], parts[5]
        ops = [(n, "M" if op in "=X" else op) for n, op in
               mb.parse_cigar(cig)]
        flag = (16 if strand == "-" else 0) | (0x81 if pe2 else 0)
        seq = dna.revcomp(rec.codes) if strand == "-" else rec.codes
        pos = start1 + (1_000 if shift_every and i % shift_every == 3
                        else 0)
        rows.append((rec.name, flag, parts[2], pos, mb.cigar_str(ops),
                     dna.decode(seq)))
    return rows


def _qc_reads(rng):
    from ..assembly.contaminants import DEFAULT_ADAPTERS
    tru = dna.encode(DEFAULT_ADAPTERS["TruSeq_R1"])
    nex = dna.encode(DEFAULT_ADAPTERS["Nextera"])
    out = []
    for i in range(200):
        ln = int(rng.integers(60, 101))
        c = rng.integers(0, 4, ln).astype(np.uint8)
        if i % 10 == 0:                       # 3' read-through
            o = int(rng.integers(6, 30))
            c[ln - o:] = tru[:o]
        elif i % 10 == 5:                     # 5' overlay
            o = int(rng.integers(6, len(nex)))
            c[:o] = nex[len(nex) - o:]
        if i % 17 == 0:
            c[rng.integers(0, ln, 3)] = dna.BASE_N
        out.append(SeqRecord(f"qc{i}", "", c,
                             rng.integers(2, 41, ln).astype(np.uint8)))
    out.append(SeqRecord("qcdup", "", out[3].codes.copy(),
                         out[3].qual.copy()))
    return out


# the golden's genes on chrT: (name, start, end, strand, CDS start, CDS
# end, exons as (start, end) from the gene's start); two on the minus
# strand, one non-coding
GENES = [
    ("gA", 1_000, 4_000, "+", 1_200, 3_800, [(0, 800), (1_500, 3_000)]),
    ("gB", 5_000, 9_000, "-", 5_300, 8_500,
     [(0, 1_000), (2_000, 2_600), (3_200, 4_000)]),
    ("gC", 10_000, 12_000, "+", 10_000, 10_000, [(0, 2_000)]),
    ("gD", 13_000, 17_000, "+", 13_100, 16_900,
     [(0, 1_200), (1_800, 4_000)]),
    ("gE", 18_000, 21_000, "-", 18_200, 20_800, [(0, 3_000)]),
    ("gF", 22_000, 26_000, "+", 22_500, 25_500,
     [(0, 900), (1_400, 2_200), (2_900, 4_000)])]


def random_genes(rng, n, glen):
    """`n` genes, as GENES gives them, of 2-4 exons at sorted distinct
    starts in [0, glen - 20,000), strands alternating, the CDS 50 bp in
    from each end."""
    genes = []
    for i, s in enumerate(np.sort(rng.choice(glen - 20_000, n,
                                             replace=False)).tolist()):
        k = int(rng.integers(2, 5))
        sizes = rng.integers(200, 1_500, k)
        gaps = rng.integers(100, 2_000, k - 1)
        offs = np.concatenate([[0], np.cumsum(sizes[:-1] + gaps)])
        ex = [(int(o), int(o + z)) for o, z in zip(offs, sizes)]
        end = s + ex[-1][1]
        genes.append((f"g{i}", s, end, "+-"[i % 2], s + 50, end - 50, ex))
    return genes


def genes_bed(path, genes=GENES, chrom="chrT",
              bed6=("gG", 27_000, 29_000)):
    """A BED file of `genes` on `chrom`, each as BED12, after a track line
    and followed by the BED6 feature `bed6` (name, start, end) where
    given."""
    with open(path, "w") as f:
        f.write("track name=genes\n")
        for name, s, e, st, cs, ce, ex in genes:
            f.write(f"{chrom}\t{s}\t{e}\t{name}\t0\t{st}\t{cs}\t{ce}\t0\t"
                    f"{len(ex)}\t{','.join(str(b - a) for a, b in ex)},\t"
                    f"{','.join(str(a) for a, _ in ex)},\n")
        if bed6:
            name, s, e = bed6
            f.write(f"{chrom}\t{s}\t{e}\t{name}\t0\t+\n")


def _de_reads(rng, n, up):
    """(pos1, flag) of `n` 50 bp reads on chrT: most in genes, gene gD at
    `up` times the others' density."""
    pos = []
    for s, e, w in ((1_000, 4_000, 1), (5_000, 9_000, 1),
                    (10_000, 12_000, 1), (13_000, 17_000, up),
                    (18_000, 21_000, 1), (22_000, 26_000, 1),
                    (27_000, 29_000, 1)):
        k = int(n * w * (e - s) / 30_000)
        pos.extend(rng.integers(s, e - 50, k).tolist())
    pos.extend(rng.integers(0, 29_950, n // 10).tolist())
    return [(int(p) + 1, 16 if rng.random() < 0.3 else 0) for p in pos]


def workload() -> dict:
    """Every input of the golden (module docstring), as numpy arrays and
    text: built from numpy seeds and the port's host modules."""
    rng = np.random.default_rng(SEED)
    bg, small = blitz_small()
    big_g, big_q = blitz_big()
    diploid = diploid_contigs(rng, 24_000, (2_000, 6_000), 3, 3_000)
    diploid.append(("tiny", rng.integers(0, 4, 80).astype(np.uint8)))
    bench_g, ctrl, ctrl_pe, raw, truth_rows = _bench_inputs(rng)
    sbs = np.random.default_rng(9).integers(0, 4, 20_000).astype(np.uint8)
    qc = _qc_reads(rng)
    contam = [SeqRecord("adA", "", dna.encode("AGATCGGAAGAGCACACGTCTGAAC")),
              SeqRecord("adB", "", dna.encode("GTTCGTCTTCTGCCGTATGCTCTA"))]
    feats = "".join(f"chrT\t{s}\t{s + ln}\t{'' if i % 5 == 4 else f'f{i}'}"
                    f"\t0\t{'+-'[i % 2]}\n" for i, (s, ln) in enumerate(
                        zip(rng.integers(0, 29_000, 40).tolist(),
                            rng.integers(50, 900, 40).tolist())))
    return dict(blitz_genome=bg, small=small, big_genome=big_g,
                big=big_q, diploid=diploid, bench_genome=bench_g,
                ctrl=ctrl, ctrl_pe=ctrl_pe, raw=raw, truth=truth_rows,
                sbs_asm=sbs, qc=qc, contam=contam, feats=feats,
                de_c=_de_reads(rng, 1_500, 1), de_e=_de_reads(rng, 2_000, 4))


def inputs_sha256(work) -> str:
    h = hashlib.sha256()
    h.update(work["blitz_genome"].tobytes())
    for key in ("small", "big", "big_genome", "diploid"):
        for name, codes in work[key]:
            h.update(name.encode() + codes.tobytes())
    for key in ("raw", "qc", "contam"):
        for r in work[key]:
            h.update(r.name.encode() + r.codes.tobytes()
                     + (b"" if r.qual is None else r.qual.tobytes()))
    h.update(work["bench_genome"].tobytes() + work["sbs_asm"].tobytes())
    h.update(repr((work["ctrl"], work["ctrl_pe"], work["truth"],
                   work["feats"], work["de_c"], work["de_e"])).encode())
    return h.hexdigest()


def write_inputs(work, d: Path, big: bool) -> None:
    """The workload's input files in `d`."""
    def recs(pairs):
        return [SeqRecord(n, "", c) for n, c in pairs]
    write_fasta(d / "blitz_g.fa", [SeqRecord("cA", "", work["blitz_genome"])])
    write_fasta(d / "small_q.fa", recs(work["small"]))
    if big:
        write_fasta(d / "big_g.fa", recs(work["big_genome"]))
        write_fasta(d / "big_q.fa", recs(work["big"]))
    write_fasta(d / "diploid.fa", recs(work["diploid"]))
    write_fasta(d / "bench_g.fa", [SeqRecord("chrT", "",
                                             work["bench_genome"])])
    chrom = [("chrT", len(work["bench_genome"]))]
    _sam(d / "ctrl.sam", chrom, work["ctrl"])
    _sam(d / "ctrl_pe.sam", chrom, work["ctrl_pe"])
    _sam(d / "truth.sam", chrom, work["truth"])
    write_fastq(d / "raw.fq", work["raw"])
    asm = work["sbs_asm"]
    write_fasta(d / "sbs_asm.fa", [SeqRecord("c1", "", asm)])
    write_fasta(d / "sbs_q.fa", [SeqRecord(f"q{i}", "",
                                           asm[i * 500:i * 500 + 80])
                                 for i in range(10)])
    write_fasta(d / "sbs_t.fa", [SeqRecord(f"t{i}", "",
                                           asm[i * 1000:i * 1000 + 2000])
                                 for i in range(8)])
    write_fastq(d / "qc.fq", work["qc"])
    write_fasta(d / "contam.fa", work["contam"])
    (d / "feats.bed").write_text(work["feats"])
    genes_bed(d / "genes.bed")
    g = work["bench_genome"]
    for name, reads in (("de_c", work["de_c"]), ("de_e", work["de_e"])):
        _sam(d / f"{name}.sam", chrom, [
            (f"{name}{i}", flag, "chrT", p, "50M",
             dna.decode(g[p - 1:p + 49])) for i, (p, flag) in
            enumerate(reads)])
    (d / "zones.csv").write_text('1,"zone","sp","chrT",13500,14000,501,"+"\n'
                                 '2,"zone","sp","chrT",100,900,801,"+"\n')


def run_cli(main, name: str, d: Path, extra=()) -> tuple[int, str]:
    """One command of RUNS in `d` through `main`; (exit code, stdout)."""
    argv = [a.format(d=d) for a in RUNS[name]] + list(extra)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _text_array(text) -> np.ndarray:
    data = text.encode() if isinstance(text, str) else text
    return np.frombuffer(data, np.uint8).copy()


def compute(fns, work=None, big: bool = False) -> dict[str, np.ndarray]:
    """Every array of the golden through `fns` (`port_fns` here, the JAX
    package's in tests/test_torch_longtail_golden.py); the big blitz set
    only with `big`."""
    from ..io.fasta import read_seqs
    work = workload() if work is None else work
    out = {"inputs_sha256": np.asarray(inputs_sha256(work))}
    with tempfile.TemporaryDirectory(prefix="longtail_golden_") as tmp:
        d = Path(tmp)
        write_inputs(work, d, big)
        for name in RUNS:
            if name in BIG_RUNS and not big:
                continue
            if name == "kmerdist":
                (d / "hits.maf").write_text(maf_text(
                    (d / "small_gapped.psl").read_text(),
                    {"cA": work["blitz_genome"]}, dict(work["small"])))
            # mode 3 scores a SAM built from the package's own mode 2 reads
            if name == "bench_m3":
                _sam(d / "sim.sam", [("chrT", 30_000)],
                     sim_sam_rows(list(read_seqs(d / "sim.fa"))))
            if name == "bench_m3_pe":
                _sam(d / "sim_pe.sam", [("chrT", 30_000)],
                     sim_sam_rows(list(read_seqs(d / "sim1.fa")))
                     + sim_sam_rows(list(read_seqs(d / "sim2.fa")),
                                    shift_every=5, pe2=True))
            before = set(p.name for p in d.iterdir())
            rc, printed = fns.run(name, d)
            if rc != 0:
                raise AssertionError(f"{name} exited {rc}")
            if printed:
                out[f"stdout:{name}"] = _text_array(printed)
            for p in sorted(d.iterdir()):
                if p.name not in before and not p.name.endswith(".npz") \
                        and not p.name.endswith(".kix"):
                    out[f"cli:{name}:{p.name}"] = _text_array(
                        p.read_bytes())
    return out


def port_fns(device="cuda") -> SimpleNamespace:
    """The callables of compute() through the port on `device`."""
    from ..cli import main
    from ..device import resolve
    dev = resolve(device)

    def run(name, d):
        extra = ["--device", dev.type] if RUNS[name][0] in DEVICE_CMDS \
            else []
        return run_cli(main, name, d, extra)
    return SimpleNamespace(run=run)


def check_reach(out: dict) -> list[str]:
    """The edges the golden is there to hold, each reached by its inputs;
    returns the ones missed."""
    def text(key):
        return bytes(np.asarray(out[key])).decode()
    by = {}
    for r in psl_rows(text("cli:blitz_small_gapped:small_gapped.psl")):
        by.setdefault(r[9], []).append(r)
    miss = []
    if not any(int(r[7]) >= 40 for r in by.get("gq", [])):
        miss.append("a 40 bp deletion bridged")
    if not any(int(r[5]) >= 20 for r in by.get("ins30", [])):
        miss.append("a 30 bp insertion bridged")
    if {r[8] for r in by.get("both", [])} != {"+", "-"}:
        miss.append("one query's chains on both strands")
    if by.get("rand") or by.get("short") or by.get("end"):
        miss.append("no hit for the random, the 8 bp and the end queries")
    if not by.get("len2048") or not by.get("len2049"):
        miss.append("queries of 2,048 and 2,049 bp")
    if "stdout:ngsqc" not in out or "stdout:bench_m4_t5" not in out:
        miss.append("ngsqc's summary and benchmark -m 4 printed")
    if int(text("cli:kmerdist:kd16.csv").splitlines()[16]
           .split(",")[1]) == 0:
        miss.append("16-mers in kmerdist")
    red = text("cli:hrdx:reduced.fa")
    if not all(f">u{i}" in red for i in range(3)) or red.count(">") >= 12:
        miss.append("hrdx keeping the unique contigs and reducing copies")
    for key in ("cli:bench_m3:score.json", "cli:bench_m3_pe:score_pe.json"):
        if '"scored": 0' in text(key):
            miss.append(f"{key} scored reads")
    big = "cli:blitz_big_gapped:big_gapped.psl"
    if big in out and len({r[9] for r in psl_rows(text(big))}) \
            < 0.9 * BIG_QUERIES:
        miss.append("the big set's planted queries hit")
    return miss


def differing(out: dict, gold) -> list[str]:
    """Keys of the golden whose array `out` lacks or does not equal (the
    big set's keys only where `out` has them)."""
    bad = []
    for k in gold.keys():
        if k not in out:
            if not any(f":{r}:" in k for r in BIG_RUNS):
                bad.append(k)
            continue
        a, b = np.asarray(out[k]), gold[k]
        if a.shape == b.shape and a.dtype == b.dtype \
                and np.array_equal(a, b):
            continue
        bad.append(k)
    bad += [k for k in out if k not in gold.keys()]
    return sorted(set(bad))
