"""The seeded workload of the converters golden file and the arrays it
holds: every converter and file tool of the command line (`bed2csv`,
`csv2bed`, `csv2fasta`, `splitmultifasta`, `quickcount`,
`gengenomefromagp`, `ufilter`, `usimdiffexpr`, `gennormwiggle`,
`fasta2bed`, `fasta2pe`, `fasta2nxx`, `xfasta`, `xroiseqs`, `genbiobed`,
`genbioseq`, the four `*2sqlite`, `csvfilter`, `csvmerge`, `csv2feat`,
`csv2stats`, `processcsvfiles`, `genhyperdropouts`, `bedfilter`,
`bedmerge`, `gfffilter`, `gtffilter`, `blast2csv` and `psl2csv`), each
mode and each flag that picks another code path, through the command line.

`kit4b_tpu_torch/data/convert_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_convert_golden.py` regenerates
it (JAX on the CPU, seconds). A machine without JAX rebuilds the same
inputs with `workload()` (numpy and the port's own host modules), runs the
port with `compute(port_fns(), work)` and compares with `differing()`:
that is how the port is held to the JAX package on the card.

The workload (`workload()`):

- a genome of three chromosomes (c1 6 kbp, c2 2.5 kbp, c3 900 bp) with N
  runs, contigs (one named with a '/') and an AGP over them (gaps of type
  N and U, both orientations, a part of a contig, comment, blank and short
  lines) and an AGP naming a contig the FASTA lacks;
- interleaved read pairs as FASTA (an odd count, names with '/', N runs)
  and as FASTQ, and an empty FASTA;
- BED features on the genome's chromosomes and one it lacks (both
  strands, BED3 and BED6 lines, '.' scores, overlaps, a feature past its
  chromosome's end and an empty one, track and comment lines), BED12 and
  BED6 gene models;
- loci CSVs (a header, a short row, both strands, a chromosome the genome
  lacks, ends past the chromosome), a second loci set to merge against,
  RefID lists, two outspecies CSVs (region bits, matches, mismatches; one
  without its score column);
- GFF3 (each gene class, scores, a short line) and GTF records with a
  contig map (space and comma separated);
- a BLAST -m8 table (comments, both subject orders, a space-separated row,
  a short row) and a PSL with its psLayout header;
- a SNP CSV by `align/snp.py`, snpmarkers CSVs in `kmer/snpmarkers.py`'s
  layout and in the `_Score` layout `snpm2sqlite` expects, DE CSVs in the
  layout `de2sqlite` expects and in `rnade`'s.

The file holds each command's output files' bytes (`cli:<run>:<path>`,
the run directory written as {d}, files in subdirectories by their path
under it), the arrays of each `.npz` it writes (`npz:<run>:<path>:<key>`,
string arrays as newline-joined text), each SQLite database as its
`iterdump()` text (`db:<run>:<path>`), the text a command prints
(`stdout:<run>`) and the SHA-256 of the inputs.
"""
from __future__ import annotations

import hashlib
import os
import sqlite3
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..io.fasta import SeqRecord, write_fasta, write_fastq
from .make_haplotypes_golden import (_text_array, differing, npz_arrays,
                                     run_cli)

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "convert_golden.npz"
SEED = 1616
CHROMS = (("c1", 6_000), ("c2", 2_500), ("c3", 900))
CONTIGS = (("ctg1", 800), ("ctg/2", 500), ("ctg3", 300))
N_PAIRS = 25          # reads.fa holds 2 * N_PAIRS + 1 records

# the commands, in order: name -> argv, with {d} the working directory
RUNS = {
    # tools/convert.py through cli.py
    "bed2csv": ["bed2csv", "-i", "{d}/feat.bed", "-o", "{d}/feat.csv"],
    "bed2csv_opts": ["bed2csv", "-i", "{d}/feat.bed", "-o", "{d}/f2.csv",
                     "-t", "exon", "-s", "hs"],
    "csv2bed": ["csv2bed", "-i", "{d}/loci.csv", "-o",
                "{d}/back.bed"],
    "csv2fasta": ["csv2fasta", "-i", "{d}/loci.csv", "-g", "{d}/g.fa", "-o",
                  "{d}/els.fa"],
    "split_one": ["splitmultifasta", "-i", "{d}/ctg.fa", "-o", "{d}/split1"],
    "split_parts": ["splitmultifasta", "-i", "{d}/reads.fa", "-o",
                    "{d}/split7", "-n", "7"],
    "quickcount": ["quickcount", "-i", "{d}/g.fa", "-o", "{d}/qc.csv"],
    "quickcount_k": ["quickcount", "-i", "{d}/reads.fq", "-o",
                     "{d}/qc37.csv", "-l", "3", "-L", "7"],
    "agp": ["gengenomefromagp", "-i", "{d}/ctg.fa", "{d}/reads.fa", "-I",
            "{d}/asm.agp", "-o", "{d}/asm.fa"],
    "ufilter": ["ufilter", "-i", "{d}/loci.csv", "-o", "{d}/uf.csv"],
    "ufilter_sel": ["ufilter", "-i", "{d}/loci.csv", "-o", "{d}/uf2.csv",
                    "-O", "{d}/uf2out.csv", "-s", "+", "-l", "50", "-Z",
                    "c[12]"],
    "ufilter_trim": ["ufilter", "-i", "{d}/loci.csv", "-o", "{d}/uf3.csv",
                     "-z", "c2", "cX", "-T", "120", "-u", "-15", "-U", "7",
                     "-l", "10"],
    "usim_m0": ["usimdiffexpr", "-o", "{d}/sim0.csv", "-t", "300", "-n",
                "1"],
    "usim_m1": ["usimdiffexpr", "-o", "{d}/sim1.tsv", "-t", "250", "-n",
                "2", "-r", "3", "-e", "20", "-R", "25", "-m", "1", "-M", "1",
                "-d", "{d}/sim1de.csv", "--seed", "7"],
    "usim_m2": ["usimdiffexpr", "-o", "{d}/sim2.csv", "-t", "200", "-n",
                "1", "-e", "10", "-R", "0", "-m", "2", "-d",
                "{d}/sim2de.csv"],
    "normwig_bed": ["gennormwiggle", "-i", "{d}/feat.bed", "-o",
                    "{d}/nw0.wig"],
    "normwig_cov": ["gennormwiggle", "-i", "{d}/feat.bed", "-m", "1", "-o",
                    "{d}/nw1.wig"],
    "normwig_csv": ["gennormwiggle", "-i", "{d}/loci.csv", "-o",
                    "{d}/nwc.wig"],
    # the FASTA tools of cli.py
    "fasta2bed": ["fasta2bed", "-i", "{d}/g.fa", "{d}/ctg.fa", "-o",
                  "{d}/g.bed"],
    "fasta2pe": ["fasta2pe", "-i", "{d}/reads.fa", "-o", "{d}/r1.fa", "-O",
                 "{d}/r2.fa"],
    "fasta2pe_fq": ["fasta2pe", "-i", "{d}/reads.fq", "-o", "{d}/q1.fa",
                    "-O", "{d}/q2.fa"],
    "fasta2nxx": ["fasta2nxx", "-i", "{d}/g.fa", "{d}/ctg.fa", "-o",
                  "{d}/nxx.json"],
    "fasta2nxx_print": ["fasta2nxx", "-i", "{d}/reads.fa"],
    "xfasta": ["xfasta", "-i", "{d}/reads.fa", "-o", "{d}/x1.fa", "-p",
               "/1$"],
    "xfasta_len": ["xfasta", "-i", "{d}/g.fa", "{d}/ctg.fa", "-o",
                   "{d}/x2.fa", "-l", "400", "-L", "2500"],
    "xroiseqs": ["xroiseqs", "-i", "{d}/feat.bed", "-g", "{d}/g.fa", "-o",
                 "{d}/roi.fa"],
    "genbiobed": ["genbiobed", "-i", "{d}/feat.bed", "-o",
                  "{d}/feat.biobed"],
    "genbioseq": ["genbioseq", "-i", "{d}/g.fa", "{d}/ctg.fa", "-o",
                  "{d}/g.seq"],
    "genbioseq_npz": ["genbioseq", "-i", "{d}/reads.fq", "-o",
                      "{d}/r.seq.npz"],
    # tools/tosqlite.py
    "snps2sqlite": ["snps2sqlite", "-i", "{d}/snps.csv", "-o",
                    "{d}/snps.db", "-w", "run1", "-W", "first run"],
    "snpm2sqlite": ["snpm2sqlite", "-i", "{d}/markers.csv", "-o",
                    "{d}/mk.db"],
    "snpm2sqlite_score": ["snpm2sqlite", "-i", "{d}/markers_score.csv",
                          "-o", "{d}/mks.db", "-w", "m2"],
    "de2sqlite": ["de2sqlite", "-i", "{d}/de.csv", "-o", "{d}/de.db"],
    "de2sqlite_rnade": ["de2sqlite", "-i", "{d}/rnade.csv", "-o",
                        "{d}/der.db", "-w", "rnade"],
    "psl2sqlite": ["psl2sqlite", "-i", "{d}/hits.psl", "-o",
                   "{d}/psl.db"],
    # cli_tools.py: tools/csvtools.py
    "csvfilter_len": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                      "{d}/cf1.csv", "-l", "50", "-L", "600"],
    "csvfilter_ids": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                      "{d}/cf2.csv", "-X", "{d}/xids.csv", "-x",
                      "{d}/iids.csv"],
    "csvfilter_loci": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                       "{d}/cf3.csv", "-E", "{d}/rel.csv", "-I",
                       "{d}/inc.csv", "-I", "{d}/loci.csv"],
    "csvfilter_chrom": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                        "{d}/cf4.csv", "-Z", "sp2", "-z", r"\.c[13]$",
                        "-s", "sp1,sp2"],
    "csvfilter_nool": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                       "{d}/cf5.csv", "-j"],
    "csvfilter_ol": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                     "{d}/cf6.csv", "-J"],
    "csvfilter_selectn": ["csvfilter", "-i", "{d}/loci.csv", "-o",
                          "{d}/cf7.csv", "-N", "9"],
    "csvfilter_rout": ["csvfilter", "-i", "{d}/os1.csv", "-o",
                       "{d}/cf8.csv", "-R", "1,4"],
    "csvfilter_rin": ["csvfilter", "-i", "{d}/os1.csv", "-o",
                      "{d}/cf9.csv", "-r", "1 3 5"],
    "csvfilter_core": ["csvfilter", "-i", "{d}/os1.csv", "-o",
                       "{d}/cf10.csv", "-a", "40", "-P", "50", "-A", "45"],
    "csvfilter_osid": ["csvfilter", "-i", "{d}/os2.csv", "-o",
                       "{d}/cf11.csv", "-k", "90", "-N", "4"],
    "csvmerge_m0": ["csvmerge", "-i", "{d}/loci.csv", "-I", "{d}/rel.csv",
                    "-o", "{d}/cm0.csv", "-p", "0"],
    "csvmerge_m1": ["csvmerge", "-i", "{d}/loci.csv", "-I", "{d}/rel.csv",
                    "-o", "{d}/cm1.csv", "-p", "1", "-r", "A", "-R", "B",
                    "-t", "blk"],
    "csvmerge_m2": ["csvmerge", "-i", "{d}/loci.csv", "-I", "{d}/rel.csv",
                    "-o", "{d}/cm2.csv", "-p", "2", "-e", "10", "-E", "5"],
    "csvmerge_m3": ["csvmerge", "-i", "{d}/loci.csv", "-I", "{d}/rel.csv",
                    "-o", "{d}/cm3.csv", "-j", "40", "-l", "20", "-L",
                    "700", "-m", "30", "-M", "2000"],
    "csvmerge_m4": ["csvmerge", "-i", "{d}/loci.csv", "-I", "{d}/rel.csv",
                    "-o", "{d}/cm4.csv", "-p", "4"],
    "csvmerge_norel": ["csvmerge", "-i", "{d}/rel.csv", "-o",
                       "{d}/cm5.csv"],
    "csv2feat": ["csv2feat", "-i", "{d}/loci.csv", "-I", "{d}/feat.bed",
                 "-o", "{d}/c2f.csv"],
    "csv2feat_bed": ["csv2feat", "-i", "{d}/loci.bed", "-I",
                     "{d}/feat.bed", "-o", "{d}/c2f2.csv", "-M", "25", "-l",
                     "30", "-L", "400"],
    "csv2stats": ["csv2stats", "-i", "{d}/loci.csv", "-I", "{d}/g.fa", "-o",
                  "{d}/c2s.csv"],
    "csv2stats_os": ["csv2stats", "-i", "{d}/os2.csv", "-I", "{d}/g.fa",
                     "-o", "{d}/c2s2.csv", "-l", "40", "-L", "500"],
    "pcf_m0": ["processcsvfiles", "-i", "{d}/loci.csv", "-I", "{d}/os*.csv",
               "-o", "{d}/pcf0.csv"],
    "pcf_m1": ["processcsvfiles", "-m", "1", "-i", "{d}/os1.csv", "-I",
               "{d}/os2.csv", "-I", "{d}/os1.csv", "-o", "{d}/pcf1.csv",
               "-X", "{d}/xids.csv"],
    "pcf_m2": ["processcsvfiles", "-m", "2", "-i", "{d}/loci.csv", "-I",
               "{d}/os1.csv", "-o", "{d}/pcf2.csv", "-l", "30", "-L",
               "500"],
    "pcf_m3": ["processcsvfiles", "-m", "3", "-i", "{d}/loci.csv", "-I",
               "{d}/os1.csv", "-o", "{d}/pcf3.csv"],
    "hdo_m0": ["genhyperdropouts", "-i", "{d}/loci.csv", "-I",
               "{d}/rel.csv", "-o", "{d}/hdo0.csv", "-O", "{d}/hdo0l.csv"],
    "hdo_m1": ["genhyperdropouts", "-p", "1", "-i", "{d}/loci.csv", "-I",
               "{d}/rel.csv", "-O", "{d}/hdo1l.csv", "-l", "5", "-L", "20"],
    "hdo_m2": ["genhyperdropouts", "-p", "2", "-i", "{d}/loci.csv", "-I",
               "{d}/rel.csv", "-o", "{d}/hdo2.csv", "-j", "40"],
    "hdo_m3": ["genhyperdropouts", "-p", "3", "-i", "{d}/loci.csv", "-I",
               "{d}/rel.csv", "-o", "{d}/hdo3.csv", "-O", "{d}/hdo3l.csv",
               "-m", "20", "-M", "600"],
    # cli_tools.py: tools/bedtools2.py
    "bedfilter": ["bedfilter", "-i", "{d}/feat.bed", "-o", "{d}/bf0.bed",
                  "-L", "400"],
    "bedfilter_plus": ["bedfilter", "-i", "{d}/feat.bed", "-o",
                       "{d}/bf1.bed", "-s", "1", "-l", "30", "-L", "900",
                       "-z", "c[12]"],
    "bedfilter_minus": ["bedfilter", "-i", "{d}/feat.bed", "-o",
                        "{d}/bf2.bed", "-s", "2", "-L", "5000", "-Z", "c3",
                        "-Z", "X"],
    "bedmerge": ["bedmerge", "-i", "{d}/feat.bed", "-o", "{d}/bm0.bed"],
    "bedmerge_strand": ["bedmerge", "-m", "1", "-i", "{d}/[fl]*[ti].bed",
                        "-o", "{d}/bm1.bed", "-j", "30", "-l", "5"],
    "bedmerge_plus": ["bedmerge", "-s", "1", "-i", "{d}/feat.bed", "-i",
                      "{d}/loci.bed", "-o", "{d}/bm2.bed", "-z", "c1",
                      "-l", "1"],
    "bedmerge_r1": ["bedmerge", "-r", "1", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr1.bed", "-l", "1", "-L",
                    "300"],
    "bedmerge_r2": ["bedmerge", "-r", "2", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr2.bed", "-l", "1"],
    "bedmerge_r3": ["bedmerge", "-r", "3", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr3.bed", "-l", "1"],
    "bedmerge_r4": ["bedmerge", "-r", "4", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr4.bed", "-l", "1"],
    "bedmerge_r5": ["bedmerge", "-r", "5", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr5.bed", "-l", "1"],
    "bedmerge_r6": ["bedmerge", "-r", "6", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr6.bed", "-l", "1"],
    "bedmerge_r7": ["bedmerge", "-r", "7", "-b", "{d}/genes.bed", "-i",
                    "{d}/feat.bed", "-o", "{d}/bmr7.bed", "-l", "1"],
    "bedmerge_r_nobed": ["bedmerge", "-r", "4", "-i", "{d}/feat.bed", "-o",
                         "{d}/bmr0.bed"],
    "gfffilter_g0": ["gfffilter", "-g", "0", "-i", "{d}/in.gff", "-o",
                     "{d}/gf0.gff"],
    "gfffilter_g1": ["gfffilter", "-i", "{d}/in.gff", "-o", "{d}/gf1.gff"],
    "gfffilter_g2": ["gfffilter", "-g", "2", "-i", "{d}/in.gff", "-o",
                     "{d}/gf2.gff"],
    "gfffilter_g3": ["gfffilter", "-g", "3", "-i", "{d}/in.gff", "-o",
                     "{d}/gf3.gff"],
    "gfffilter_g4": ["gfffilter", "-g", "4", "-i", "{d}/in.gff", "-o",
                     "{d}/gf4.gff"],
    "gfffilter_g5": ["gfffilter", "-g", "5", "-i", "{d}/in.gff", "-o",
                     "{d}/gf5.gff"],
    "gfffilter_g6": ["gfffilter", "-g", "6", "-i", "{d}/in.gff", "-o",
                     "{d}/gf6.gff"],
    "gfffilter_bed": ["gfffilter", "-m", "1", "-g", "0", "-n", "gene_name",
                      "-s", "2.5", "-i", "{d}/in.gff", "-o",
                      "{d}/gf.bed"],
    "gtffilter": ["gtffilter", "-i", "{d}/in.gtf", "-o", "{d}/gt0.gtf"],
    "gtffilter_map": ["gtffilter", "-i", "{d}/in.gtf", "-I", "{d}/map.txt",
                      "-o", "{d}/gt1.gtf"],
    # cli_tools.py: tools/blastpsl.py
    "blast2csv": ["blast2csv", "-i", "{d}/hits.m8", "-o", "{d}/bl.csv"],
    "blast2csv_chrom": ["blast2csv", "-i", "{d}/hits.m8", "-o",
                        "{d}/bl2.csv", "-Z", "chrM", "-z", "chr[12]"],
    "psl2csv": ["psl2csv", "-i", "{d}/hits.psl", "-o", "{d}/psl.csv"],
    "psl2csv_chrom": ["psl2csv", "-i", "{d}/hits.psl", "-o",
                      "{d}/psl2.csv", "-z", "c1", "-Z", "c2"],
}


def _codes(rng, n: int) -> np.ndarray:
    return rng.integers(0, 4, n).astype(np.uint8)


def _loci_rows(rng, n: int, first: int = 1) -> list[dict]:
    """Loci CSV rows on the genome's chromosomes and one it lacks, some
    past their chromosome's end."""
    rows = []
    for i in range(n):
        chrom, size = CHROMS[i % 3] if i % 11 != 10 else ("cX", 500)
        ln = int(rng.integers(5, 800))
        s = int(rng.integers(0, size - 4))
        rows.append({"srcid": first + i, "type": ("hyper", "ultra")[i % 2],
                     "species": ("sp1", "sp2")[i % 2 if i % 7 else 0],
                     "chrom": chrom, "start": s, "end": s + ln - 1,
                     "len": ln, "strand": "-" if i % 3 == 1 else "+"})
    return rows


def workload() -> dict:
    """Every input of the golden (module docstring): numpy arrays and
    text, built from numpy seeds and the port's host modules."""
    rng = np.random.default_rng(SEED)
    genome = {c: _codes(rng, n) for c, n in CHROMS}
    genome["c1"][1_000:1_060] = dna.BASE_N
    genome["c2"][:30] = dna.BASE_N
    genome["c3"][400:405] = dna.BASE_N
    contigs = {c: _codes(rng, n) for c, n in CONTIGS}
    reads = []
    for i in range(N_PAIRS):
        for m in (1, 2):
            r = _codes(rng, int(rng.integers(60, 140)))
            if i % 6 == 2:
                r[10:14] = dna.BASE_N
            reads.append((f"p{i}/{m}", r))
    reads.append(("lone/1", _codes(rng, 90)))
    fq = [(f"q{i}/{1 + i % 2}", _codes(rng, 80),
           rng.integers(2, 41, 80).astype(np.uint8)) for i in range(21)]
    loci = _loci_rows(rng, 44)
    rel = _loci_rows(rng, 26, first=101)
    for e, r in zip(loci[::4], rel[::2]):        # near-copies: overlaps
        r.update(chrom=e["chrom"], start=e["start"] + 3,
                 end=e["end"] + int(rng.integers(-30, 30)))
        r["len"] = max(1, r["end"] - r["start"] + 1)
    return dict(genome=genome, contigs=contigs, reads=reads, fq=fq,
                loci=loci, rel=rel, feats=_features(rng),
                outspecies=_outspecies(rng, loci), hits=_blast_rows(rng),
                psl=_psl_rows(rng), snps=_snp_rows(rng, genome))


def _features(rng) -> list[tuple]:
    """BED rows (chrom, start, end, name, score, strand); None fields are
    left out of the line."""
    out = []
    for i in range(36):
        chrom, size = CHROMS[i % 3] if i % 13 != 12 else ("cX", 500)
        s = int(rng.integers(0, size - 10))
        e = s + int(rng.integers(1, 900))
        kind = i % 5
        if kind == 0:                              # BED3
            out.append((chrom, s, e, None, None, None))
        elif kind == 1:
            out.append((chrom, s, e, f"f{i}", ".", "-"))
        else:
            out.append((chrom, s, e, f"f{i}", int(rng.integers(0, 900)),
                        "-" if kind == 4 else "+"))
    out += [("c1", 250, 330, "utr5A", 1, "+"), ("c1", 2_050, 2_150,
                                                 "utr3A", 2, "-"),
            ("c1", 4_150, 4_190, "utr5B", 3, "-"),
            ("c2", 1_000, 1_100, "intronC", 4, "+")]
    out.append(("c1", 5_900, 6_300, "past_end", 5, "+"))
    out.append(("c2", 700, 700, "empty", 0, "-"))
    out.append(("c2", 40, 120, "", 3, "-"))
    return out


def _outspecies(rng, loci) -> list[list[dict]]:
    """Two outspecies CSVs over the loci's SrcIDs: region bits, matches,
    mismatches; the second written without its score column."""
    sets = []
    for k in (1, 2):
        rows = []
        for e in loci:
            if rng.random() < 0.25:
                continue
            al = int(rng.integers(0, e["len"] + 1))
            mm = int(rng.integers(0, al // 4 + 1))
            rows.append({**e, "relspecies": f"rel{k}",
                         "features": int(rng.choice(
                             [0, 0, 1, 2, 4, 8, 16, 32, 3, 9])),
                         "unaligned": e["len"] - al, "matches": al - mm,
                         "mismatches": mm, "indels": int(rng.integers(0, 3)),
                         "score": int(rng.integers(0, 1000))})
        sets.append(rows)
    return sets


def _blast_rows(rng) -> list[list]:
    rows = []
    for i in range(14):
        q = f"q{i % 5}"
        s = ("chr1", "chr2", "chrM", "chr3")[i % 4]
        ln = int(rng.integers(30, 200))
        ss = int(rng.integers(1, 5_000))
        se = ss + ln - 1 if i % 3 else ss - ln + 1
        rows.append([q, s, f"{rng.uniform(80, 100):.2f}", ln,
                     int(rng.integers(0, 9)), int(rng.integers(0, 3)), 1, ln,
                     ss, se, f"{10.0 ** -int(rng.integers(3, 80)):.2g}",
                     f"{rng.uniform(20, 400):.1f}"])
    return rows


def _psl_rows(rng) -> list[list]:
    rows = []
    for i in range(10):
        tname = ("c1", "c2", "c3")[i % 3]
        b1, b2 = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        gap = int(rng.integers(0, 8))
        qs, ts = int(rng.integers(0, 20)), int(rng.integers(0, 1_500))
        mm = int(rng.integers(0, 5))
        rows.append([b1 + b2 - mm, mm, i % 2, 0, int(gap > 0), gap, 1,
                     int(rng.integers(1, 40)), "+-"[i % 2], f"q{i}",
                     qs + b1 + b2 + gap + 7, qs, qs + b1 + b2 + gap, tname,
                     2_500, ts, ts + b1 + b2 + 40, 2, f"{b1},{b2},",
                     f"{qs},{qs + b1 + gap},", f"{ts},{ts + b1 + 40},"])
    return rows


def _snp_rows(rng, genome) -> list[tuple]:
    """(chrom, loci, ref, counts [5], pvalue) of a few SNP calls."""
    rows = []
    for i in range(16):
        chrom = ("c1", "c2")[i % 2]
        p = int(rng.integers(40, len(genome[chrom]) - 40))
        ref = int(genome[chrom][p]) % 4
        c = np.zeros(5, np.int64)
        c[ref] = int(rng.integers(0, 6))
        c[(ref + 1 + i % 3) % 4] = int(rng.integers(3, 30))
        c[4] = i % 4 == 0
        rows.append((chrom, p, ref, c, 10.0 ** -int(rng.integers(2, 12))))
    return rows


def _loci_csv(rows) -> str:
    return "".join(f'{e["srcid"]},"{e["type"]}","{e["species"]}",'
                   f'"{e["chrom"]}",{e["start"]},{e["end"]},{e["len"]},'
                   f'"{e["strand"]}"\n' for e in rows)


def write_inputs(work, d: Path) -> None:
    """The workload's input files in `d`."""
    from ..align.rnade import FeatDE, write_rnade_csv
    from ..align.snp import SnpCall, write_snps_csv
    from ..kmer.snpmarkers import SnpMarker, write_snp_markers_csv
    from ..tools.csvtools import write_outspecies_csv
    write_fasta(d / "g.fa", [SeqRecord(c, "", g)
                             for c, g in work["genome"].items()])
    write_fasta(d / "ctg.fa", [SeqRecord(c, "", g)
                               for c, g in work["contigs"].items()])
    write_fasta(d / "reads.fa", [SeqRecord(n, "", r)
                                 for n, r in work["reads"]])
    write_fastq(d / "reads.fq", [SeqRecord(n, "", r, q)
                                 for n, r, q in work["fq"]])
    (d / "empty.fa").write_text("")
    (d / "asm.agp").write_text(
        "# AGP over ctg.fa\n\n"
        "chrA\t1\t800\t1\tW\tctg1\t1\t800\t+\n"
        "chrA\t801\t850\t2\tN\t50\tscaffold\tyes\tpaired-ends\n"
        "chrA\t851\t1240\t3\tW\tctg/2\t11\t400\t-\n"
        "chrA\t1241\t1340\t4\tU\t100\tcontig\tno\tna\n"
        "chrA\t1341\t1640\t5\tW\tctg3\t1\t300\n"
        "chrB\t1\t300\t1\tW\tctg3\t1\t300\t-\n"
        "chrB\tshort\n"
        "chrB\t301\t390\t2\tW\tp3/1\t1\t90\t+\n")
    (d / "bad.agp").write_text("chrA\t1\t800\t1\tW\tnope\t1\t800\t+\n")
    lines = ["track name=feats\n", "# features\n"]
    for chrom, s, e, name, score, strand in work["feats"]:
        cells = [chrom, str(s), str(e)] + [str(x) for x in (name, score,
                                                            strand)
                                           if x is not None]
        lines.append("\t".join(cells) + "\n")
    (d / "feat.bed").write_text("".join(lines))
    (d / "genes.bed").write_text(
        "c1\t200\t2200\tgA\t0\t+\t400\t2000\t0\t3\t500,400,600,\t"
        "0,900,1400,\n"
        "c1\t3000\t4200\tgB\t0\t-\t3100\t4100\t0\t2\t300,500,\t0,700,\n"
        "c2\t500\t1500\tgC\t0\t+\t500\t500\t0\t2\t200,300,\t0,700,\n"
        "c3\t100\t600\tgD\t0\t-\n")
    head = '"SrcID","ElType","Species","Chrom","StartLoci","EndLoci",' \
        '"Len","Strand"\n'
    (d / "loci.csv").write_text(head + _loci_csv(work["loci"]) +
                                "bad,row\n")
    (d / "rel.csv").write_text(_loci_csv(work["rel"]))
    (d / "inc.csv").write_text(_loci_csv(work["rel"][::3]))
    (d / "loci.bed").write_text("".join(
        f'{e["chrom"]}\t{e["start"]}\t{e["end"] + 1}\tl{e["srcid"]}\t0\t'
        f'{e["strand"]}\n' for e in work["loci"][:30]))
    (d / "xids.csv").write_text('"SrcID"\n' + "".join(
        f"{e['srcid']},x\n" for e in work["loci"][::5]))
    (d / "iids.csv").write_text("".join(
        f'"{e["srcid"]}"\n' for e in work["loci"][:30:2]) + "none\n")
    os1, os2 = work["outspecies"]
    write_outspecies_csv(d / "os1.csv", os1)
    write_outspecies_csv(d / "os2.csv", os2)
    (d / "os2.csv").write_text("".join(      # without the score column
        ln.rsplit(",", 1)[0] + "\n"
        for ln in (d / "os2.csv").read_text().splitlines()))
    (d / "in.gff").write_text("".join([
        "##gff-version 3\n", "# a comment\n",
        "c1\tsrc\tgene\t201\t2200\t.\t+\t.\tID=gA;Name=GA;gene_name=ga\n",
        "c1\tsrc\tmRNA\t201\t2200\t12.5\t+\t.\tID=mA;Parent=gA\n",
        "c1\tsrc\tCDS\t401\t900\t3\t+\t0\tID=cA;Parent=mA\n",
        "c1\tsrc\texon\t201\t700\t.\t+\t.\tParent=mA\n",
        "c1\tsrc\tprotein\t401\t900\t.\t+\t.\tName=PA\n",
        "c1\tsrc\ttRNA\t2500\t2572\t400\t-\t.\tID=t1;Name=T1\n",
        "c2\tsrc\tmiRNA\t100\t121\t.\t+\t.\tID=mi1\n",
        "c2\tsrc\tmiRNA_primary_transcript\t80\t150\t.\t+\t.\tID=mp1\n",
        "c2\tsrc\tsnoRNA\t300\t380\t1000\t-\t.\tID=sn1;Name=SN1\n",
        "c2\tsrc\tpseudogene\t900\t1500\t.\t+\t.\tID=ps1\n",
        "c2\tsrc\tpseudogenic_exon\t900\t1100\t.\t+\t.\tParent=ps1\n",
        "c3\tsrc\ttransposable_element\t10\t800\t7\t+\t.\tID=te1\n",
        "c3\tsrc\ttransposon\t20\t90\t.\t-\t.\t\n",
        "c3\tsrc\tncRNA\t100\t200\t.\t+\t.\tID=nc1;bad;k = v \n",
        "c3\tsrc\tgene\n",
        "c3\tsrc\tgene\t300\t400\t.\t+\t.\n"]))
    (d / "in.gtf").write_text("".join([
        "#!genome-build test\n",
        'ctg1\tsrc\tgene\t1\t800\t.\t+\t.\tgene_id "g1"; gene_name "G1";\n',
        'ctg1\tsrc\texon\t1\t50\t2\t+\t.\tgene_id "g1"; transcript_id '
        '"t1"; exon_number "1";\n',
        'ctg3\tsrc\tCDS\t10\t99\t.\t-\t2\tgene_id "g3";\n',
        'c2\tsrc\texon\t5\t60\t.\t-\t.\tgene_id "g2"; note;\n',
        "c2\tsrc\tgene\t5\t60\n"]))
    (d / "map.txt").write_text("ctg1 chrX\nc2,chrY\nlonely\n")
    hits = ["# BLASTN 2.2\n", "# Fields: query id, subject id, ...\n", "\n"]
    for i, r in enumerate(work["hits"]):
        hits.append((" " if i == 5 else "\t").join(map(str, r)) + "\n")
    hits.append("q9\tchr1\t99.0\t10\n")
    (d / "hits.m8").write_text("".join(hits))
    (d / "hits.psl").write_text(
        "psLayout version 3\n\nmatch\tmis-\trep.\tN's\tQ gap\tQ gap\tT gap"
        "\tT gap\tstrand\tQ\tQ\tQ\tQ\tT\tT\tT\tT\tblock\tblockSizes\t"
        "qStarts\t tStarts\n" + "-" * 60 + "\n" + "".join(
            "\t".join(map(str, r)) + "\n" for r in work["psl"]) +
        "12\t0\t0\n")
    write_snps_csv(d / "snps.csv", [
        SnpCall(c, p, ref, cnt, int(cnt.sum()),
                int(cnt.sum() - cnt[ref]), 0.01, pv)
        for c, p, ref, cnt, pv in work["snps"]], experiment="e16")
    marks = [SnpMarker(c, p, "ACGT"[ref], {
        "A": ("ACGT"[(ref + 1) % 4], 0.95), "B": ("ACGT"[ref], 1.0)})
        for c, p, ref, _, _ in work["snps"][:10]]
    write_snp_markers_csv(d / "markers.csv", marks, ["A", "B"])
    (d / "markers_score.csv").write_text(
        "Chrom,Loci,RefBase,A,A_Score,B,B_Score\n" + "".join(
            f"{m.chrom},{m.loci},{m.ref_base},{m.alleles['A'][0]},"
            f"{i * 7 % 50},{m.alleles['B'][0]},{i % 3}.5\n"
            for i, m in enumerate(marks)) + "c3,5,A,C,,G,\n")
    (d / "de.csv").write_text(
        '"Feature","Classification","FoldChange","PearsonCtrl",'
        '"PearsonExpr"\n"gene1","up",2.5,0.9,0.8\n"gene2","down",0.25,'
        '0.5,\n"gene3","",,,\n')
    write_rnade_csv(d / "rnade.csv", [
        FeatDE(f"g{i}", feat_len=900 + i, n_exons=1 + i % 3,
               user_class=1 + i % 4, obs_fold=0.5 + i, obs_pearson=0.1 * i,
               ctrl_cnts=10 * i, expr_cnts=7 * i + 1) for i in range(5)])


def inputs_sha256(work) -> str:
    h = hashlib.sha256()
    for key in ("genome", "contigs"):
        for c, g in work[key].items():
            h.update(c.encode() + g.tobytes())
    for n, r in work["reads"]:
        h.update(n.encode() + r.tobytes())
    for n, r, q in work["fq"]:
        h.update(n.encode() + r.tobytes() + q.tobytes())
    h.update(repr([work[k] for k in ("loci", "rel", "feats", "outspecies",
                                     "hits", "psl")]).encode())
    for c, p, ref, cnt, pv in work["snps"]:
        h.update(f"{c}{p}{ref}{pv!r}".encode() + cnt.tobytes())
    return h.hexdigest()


def db_dump(path: Path) -> str:
    """A SQLite database as sqlite3's `iterdump()` text."""
    con = sqlite3.connect(path)
    try:
        return "\n".join(con.iterdump())
    finally:
        con.close()


def files(d: Path) -> set[str]:
    """The files under `d`, by their path under it."""
    return {os.path.relpath(os.path.join(root, f), d)
            for root, _, names in os.walk(d) for f in names}


def collect(out: dict, name: str, d: Path, before: set) -> None:
    """The files a run wrote under `d` into `out`: a .npz's arrays, a
    SQLite database's dump, else the bytes, the directory written as {d}
    (processcsvfiles names its inputs in its header, each database its
    input file)."""
    for rel in sorted(files(d) - before):
        p = d / rel
        if rel.endswith(".npz"):
            for k, a in npz_arrays(p).items():
                out[f"npz:{name}:{rel}:{k}"] = a
        elif rel.endswith(".db"):
            out[f"db:{name}:{rel}"] = _text_array(
                db_dump(p).replace(str(d), "{d}"))
        else:
            out[f"cli:{name}:{rel}"] = _text_array(
                p.read_bytes().replace(str(d).encode(), b"{d}"))


def compute(fns, work=None) -> dict[str, np.ndarray]:
    """Every array of the golden through `fns` (`port_fns` here, the JAX
    package's in tests/test_torch_convert_golden.py)."""
    work = workload() if work is None else work
    out = {"inputs_sha256": np.asarray(inputs_sha256(work))}
    with tempfile.TemporaryDirectory(prefix="convert_golden_") as tmp:
        d = Path(tmp)
        write_inputs(work, d)
        for name, argv_t in RUNS.items():
            before = files(d)
            rc, printed = fns.run(argv_t, d)
            if rc != 0:
                raise AssertionError(f"{name} exited {rc}")
            if printed:
                out[f"stdout:{name}"] = _text_array(printed)
            collect(out, name, d, before)
    return out


def port_fns() -> SimpleNamespace:
    """The callables of compute() through the port's CLI (host only: no
    command of the workload takes a device)."""
    from ..cli import main
    return SimpleNamespace(run=lambda argv_t, d: run_cli(main, argv_t, d))


def check_reach(out: dict) -> list[str]:
    """The edges the golden is there to hold, each reached by its inputs;
    returns the ones missed."""
    def text(key):
        return bytes(np.asarray(out[key])).decode()

    def rows(key):
        return text(key).splitlines()
    miss = []
    split = [k for k in out if k.startswith("cli:split_one:")]
    if "cli:split_one:split1/ctg_2.fa" not in split or len(split) != 3:
        miss.append(f"splitmultifasta's '/' in a name ({split})")
    if len([k for k in out if k.startswith("cli:split_parts:")]) != 8:
        miss.append("splitmultifasta's parts and its short last one")
    if "-" not in "".join(ln.split("\t")[5] for ln in rows(
            "cli:bedfilter_minus:bf2.bed")):
        miss.append("bedfilter's '-' strand")
    roi = text("cli:xroiseqs:roi.fa")
    if "(-)" not in roi or "c2:40-120(-)" not in roi or \
            "past_end c1:5900-6000(+)" not in roi or ">empty" in roi:
        miss.append("xroiseqs' strands, clip, unnamed and empty features")
    if len(rows("cli:csvfilter_selectn:cf7.csv")) != 9:
        miss.append("csvfilter's SelectN")
    for m in range(5):
        if not rows(f"cli:csvmerge_m{m}:cm{m}.csv"):
            miss.append(f"csvmerge -p {m}")
    for key in ("cli:csvfilter_rout:cf8.csv", "cli:csvfilter_rin:cf9.csv",
                "cli:csvfilter_core:cf10.csv", "cli:csvfilter_osid:cf11.csv",
                "cli:csvfilter_nool:cf5.csv", "cli:csvfilter_ol:cf6.csv",
                "cli:csvfilter_loci:cf3.csv"):
        n = len(rows(key))
        if n == 0 or n >= 44:
            miss.append(f"{key}: {n} rows kept")
    if "+joined" not in text("cli:hdo_m3:hdo3.csv"):
        miss.append("genhyperdropouts' joined class")
    bm = [text(f"cli:bedmerge_r{r}:bmr{r}.bed") for r in range(1, 8)]
    if not all(bm) or len(set(bm)) < 5:
        miss.append("bedmerge's regions")
    for g in range(1, 7):
        if len(rows(f"cli:gfffilter_g{g}:gf{g}.gff")) < 2:
            miss.append(f"gfffilter -g {g}")
    if '"-"' not in text("cli:blast2csv:bl.csv") or \
            "chrM" in text("cli:blast2csv_chrom:bl2.csv"):
        miss.append("blast2csv's strands and chrom filters")
    if "'MarkerID'" not in text("db:snpm2sqlite:mk.db"):
        miss.append("snpm2sqlite's MarkerID cultivar")
    if [ln for ln in rows("cli:agp:asm.fa") if ln[0] == ">"] != \
            [">chrA", ">chrB"]:
        miss.append("gengenomefromagp's objects")
    if text("cli:normwig_bed:nw0.wig") == text("cli:normwig_cov:nw1.wig"):
        miss.append("gennormwiggle's modes")
    if len(rows("cli:usim_m1:sim1de.csv")) != 51:
        miss.append("usimdiffexpr's DE list")
    if '"{d}/os1.csv","{d}/os2.csv"' not in text("cli:pcf_m0:pcf0.csv"):
        miss.append("processcsvfiles' glob")
    return miss
