"""The seeded workload of the haplotypes golden file and the arrays it holds:
every mode of `callhaplotypes` (0-12), `pbautils` (0-8, `concat`,
`coverage`), `snpmarkers`, `snps2pgsnps` (pgSnp and VCF), `lochap2bed`,
`markerseqs`, `repassemb`, `pangenome` (0-3), `seghaplotypes` (with and
without -I), `gbsmapsnps` (0, 1) and `dgts` (0, 1), each through the
command line.

`kit4b_tpu_torch/data/haplotypes_golden.npz` holds the JAX package's
answers on this workload; `python tests/test_torch_haplotypes_golden.py`
regenerates it (JAX on the CPU, seconds). A machine without JAX rebuilds
the same inputs with `workload()` (numpy and the port's own host
modules), runs the port with `compute(port_fns(), work)` and compares with
`differing()`: that is how the port is held to the JAX package on the card.

The workload (`workload()`), on a seeded genome of two chromosomes (c1
40 kbp, c2 9 kbp):

- founders FA, FB and FC: dirac PBAs of the genome with 8 % of FB's and
  FC's loci moved to another base, a few loci uncovered, FB in the
  reference's binary container;
- progeny P1-P4 (skim PBAs, 60 % of loci covered at scores 1-3): P1 a
  mosaic with two switches, P2 with a heterozygous run (both founders'
  alleles), P3 switching at random bin by bin (the runs test's region), P4
  one founder with a single outlier bin and two 10 kbp stretches all
  but uncovered;
- twelve group samples, four from each of FA, FB and FC, with allele
  noise and gap runs (the grouping modes 3-6 and 10);
- PBAs of unequal chromosome lengths and an extra chromosome (`concat`),
  and one covered at both ends of c1 with an uncovered c3 (`coverage`);
- SNP CSVs of three cultivars written by `align/snp.py` (fixed, impure
  and thin loci, loci only one cultivar has, a chromosome the genome
  lacks, loci at both chromosome ends), DiSNP and TriSNP CSVs of one
  allele combination a row;
- a founder-tagged SAM over FA|#c1 and FB|#c1 with unmapped, duplicate
  and untagged records, a pangenome FASTA, snpmarkers CSVs in this
  framework's layout and the reference's;
- GBS CSVs (homozygous, heterozygous, NA, single-base and mismatching
  cells, non-discriminating rows, a short row) with 2- and 3-field
  chromosome maps (a locus past the chromosome's size);
- QTL CSVs (a header, a row without ALT) and a generic DGT CSV;
- the genome's dirac PBA as the reference PBA of `pbautils` 4-7 and
  `dgts`.

The file holds each command's output files' bytes (`cli:<run>:<file>`),
the arrays of each `.npz` it writes (`npz:<run>:<file>:<key>`, the names
as text) and the SHA-256 of the inputs.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from ..io.fasta import SeqRecord, write_fasta

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "haplotypes_golden.npz"
SEED = 1515
CHROMS = (("c1", 40_000), ("c2", 9_000))
SHIFTS = np.array([6, 4, 2, 0], np.uint8)
FOUNDERS = ("FA", "FB", "FC")
PROGENY = ("P1", "P2", "P3", "P4")
GROUP_SAMPLES = tuple(f"S{i:02d}" for i in range(12))

_F = ["-c", "FA={d}/FA.pba.npz", "FB={d}/FB.pba"]
_P = ["-i", "P1={d}/P1.pba.npz", "P2={d}/P2.pba", "P3={d}/P3.pba.npz",
      "P4={d}/P4.pba.npz"]
_G = ["-c"] + [f"{s}={{d}}/{s}.pba{'' if i % 3 == 1 else '.npz'}"
               for i, s in enumerate(GROUP_SAMPLES)]
_GRP = ["-n", "3", "--grpdgtsamples", "0.1", "-g", "3000", "-C", "c2"]
_SAMPLES5 = ["{d}/FA.pba.npz", "{d}/FB.pba", "{d}/P1.pba.npz",
             "{d}/P2.pba", "{d}/P4.pba.npz"]
# the commands, in order: name -> argv, with {d} the working directory
RUNS = {
    "ch_m0": ["callhaplotypes", "-m", "0", *_F, *_P, "-o", "{d}/m0",
              "-b", "500"],
    "ch_m0_one": ["callhaplotypes", *_F, "-i", "{d}/P1.pba.npz", "-o",
                  "{d}/one.csv", "-b", "500", "--minloci", "8"],
    "ch_m1": ["callhaplotypes", "-m", "1", *_F, *_P, "-o", "{d}/m1",
              "-b", "500", "--wwrlproxwindow", "0"],
    "ch_m2": ["callhaplotypes", "-m", "2", *_F, *_P, "-o", "{d}/m2",
              "-b", "500", "--wwrlproxwindow", "20000"],
    "ch_m2_three": ["callhaplotypes", "-m", "2", *_F, "FC={d}/FC.pba.npz",
                    *_P, "-o", "{d}/m2f3", "-b", "4000",
                    "--minloci", "3"],
    "ch_m3": ["callhaplotypes", "-m", "3", *_G, *_GRP, "-o", "{d}/m3.csv"],
    "ch_m3_c1": ["callhaplotypes", "-m", "3", *_G, "-n", "3", "-g",
                 "20000", "-a", "0", "-G", "2", "-d", "2", "-o",
                 "{d}/m3c1.csv"],
    "ch_m4": ["callhaplotypes", "-m", "4", *_G, *_GRP, "-o", "{d}/m4.csv"],
    "ch_m5": ["callhaplotypes", "-m", "5", *_G, *_GRP, "-o", "{d}/m5.csv"],
    "ch_m5_cap": ["callhaplotypes", "-m", "5", *_G, *_GRP, "-N", "7",
                  "-Q", "0.8", "-o", "{d}/m5cap.csv"],
    "ch_m6": ["callhaplotypes", "-m", "6", *_G, *_GRP, "-p", "3", "-o",
              "{d}/m6.wig"],
    "ch_m10": ["callhaplotypes", "-m", "10", *_G, *_GRP, "-k", "12",
               "-K", "2", "-o", "{d}/m10.csv"],
    "ch_m10_nocov": ["callhaplotypes", "-m", "10", *_G, *_GRP, "-k", "20",
                     "-K", "3", "-U", "2", "-o", "{d}/m10u.csv"],
    "ch_m7": ["callhaplotypes", "-m", "7", *_F, "FC={d}/FC.pba.npz", *_P,
              "-g", "10000", "-o", "{d}/m7.csv"],
    "ch_m8": ["callhaplotypes", "-m", "8", *_F, "FC={d}/FC.pba.npz",
              "P1={d}/P1.pba.npz", "-g", "4000", "-o", "{d}/m8.csv"],
    "ch_m9": ["callhaplotypes", "-m", "9", "-A", "{d}/m7.csv", "-o",
              "{d}/m9"],
    "ch_m9_prune": ["callhaplotypes", "-m", "9", "-A", "{d}/m7.csv",
                    "--minunprunedrefs", "1", "-P", "1", "-o", "{d}/m9p"],
    "ch_m11": ["callhaplotypes", "-m", "11", "-A", "{d}/m7.csv", "-r",
               "^P[12]$", "-R", "F[AC]", "-o", "{d}/m11.csv"],
    "ch_m11_none": ["callhaplotypes", "-m", "11", "-A", "{d}/m7.csv", "-r",
                    "nomatch", "-o", "{d}/m11n.csv"],
    "ch_m12": ["callhaplotypes", "-m", "12", "-A", "{d}/m7.csv", "-R",
               "F[AB]", "-o", "{d}/m12.csv"],
    "ch_m12_none": ["callhaplotypes", "-m", "12", "-A", "{d}/m8.csv",
                    "-R", "nomatch", "-o", "{d}/m12n.csv"],
    "pu_m0": ["pbautils", "-m", "0", "-i", "{d}/P2.pba", "-o",
              "{d}/p2.fa"],
    "pu_m1": ["pbautils", "-m", "1", "-i", "{d}/g.fa", "-o",
              "{d}/asm.pba.npz"],
    "pu_m2": ["pbautils", "-m", "2", "-i", "{d}/FA.pba.npz", "{d}/FB.pba",
              "{d}/P1.pba.npz", "{d}/S00.pba.npz", "-o", "{d}/conc.csv"],
    "pu_m3": ["pbautils", "-m", "3", "-i", *_SAMPLES5, "-o",
              "{d}/wconc.csv"],
    "pu_m4": ["pbautils", "-m", "4", "-r", "{d}/ref.pba.npz", "-i",
              "{d}/P2.pba", "-o", "{d}/allelic.vcf"],
    "pu_m5": ["pbautils", "-m", "5", "-r", "{d}/ref.pba.npz", "-i",
              *_SAMPLES5, "-o", "{d}/gt.vcf"],
    "pu_m5_na": ["pbautils", "-m", "5", "-r", "{d}/ref.pba.npz", "-i",
                 *_SAMPLES5, "--gtpropna", "0.1", "-o", "{d}/gtna.vcf"],
    "pu_m6": ["pbautils", "-m", "6", "-r", "{d}/FA.pba.npz", "-i",
              *_SAMPLES5, "--gtprophet", "0.2", "-o", "{d}/dip.vcf"],
    "pu_m7": ["pbautils", "-m", "7", "-r", "{d}/ref.pba.npz", "-i",
              "{d}/S03.pba.npz", "{d}/FA.pba.npz", "-o", "{d}/del.vcf"],
    "pu_m8": ["pbautils", "-m", "8", "-i", "{d}/S00.pba.npz", "{d}/cov.pba",
              "-o", "{d}/tx.bed"],
    "pu_concat": ["pbautils", "-m", "concat", "-i", "{d}/X.pba.npz",
                  "{d}/Y.pba.npz", "{d}/FB.pba.npz", "-o",
                  "{d}/cat.pba.npz"],
    "pu_coverage": ["pbautils", "-m", "coverage", "-i", "{d}/cov.pba.npz",
                    "-o", "{d}/cov.wig"],
    "snpmarkers": ["snpmarkers", "-c", "A={d}/A.snps.csv",
                   "B={d}/B.snps.csv", "C={d}/C.snps.csv", "-o",
                   "{d}/snpmk.csv"],
    "snpmarkers_opts": ["snpmarkers", "-c", "B={d}/B.snps.csv",
                        "A={d}/A.snps.csv", "-m", "12", "-p", "95", "-o",
                        "{d}/mk2.csv"],
    "snps2pgsnps": ["snps2pgsnps", "-i", "{d}/B.snps.csv", "-o",
                    "{d}/b.pgsnp"],
    "snps2pgsnps_opts": ["snps2pgsnps", "-i", "{d}/A.snps.csv", "-o",
                         "{d}/a.pgsnp", "-t", "trk", "-c", "3"],
    "snps2pgsnps_vcf": ["snps2pgsnps", "-i", "{d}/B.snps.csv", "-o",
                        "{d}/b.vcf"],
    "lochap2bed_di": ["lochap2bed", "-i", "{d}/b.disnp.csv", "-o",
                      "{d}/di.bed"],
    "lochap2bed_tri": ["lochap2bed", "-i", "{d}/b.trisnp.csv", "-o",
                       "{d}/tri.bed"],
    "markerseqs": ["markerseqs", "-i", "{d}/B.snps.csv", "-g", "{d}/g.fa",
                   "-o", "{d}/ms.csv"],
    "markerseqs_l10": ["markerseqs", "-i", "{d}/A.snps.csv", "-g",
                       "{d}/g.fa", "-o", "{d}/ms10.csv", "-l", "10"],
    "repassemb": ["repassemb", "-i", "{d}/B.snps.csv", "-g", "{d}/g.fa",
                  "-o", "{d}/rep.fa"],
    "repassemb_p": ["repassemb", "-i", "{d}/A.snps.csv", "-g", "{d}/g.fa",
                    "-o", "{d}/rep2.fa", "-p", "0.9"],
    "pg_m0": ["pangenome", "-m", "0", "-p", "FA", "-i", "{d}/g.fa", "-o",
              "{d}/pgA.fa"],
    "pg_m1": ["pangenome", "-m", "1", "-p", "FB", "-i", "{d}/pg.sam", "-o",
              "{d}/pgB.sam"],
    "pg_m2": ["pangenome", "-m", "2", "-b", "2", "-i", "{d}/pg.sam", "-o",
              "{d}/pg2.wig"],
    "pg_m3": ["pangenome", "-m", "3", "-b", "2", "-p", "uniq", "-i",
              "{d}/pg.sam", "-o", "{d}/pg3.wig"],
    "sh": ["seghaplotypes", "-i", "{d}/pg.sam", "-o", "{d}/sh.bed", "-b",
           "2", "--minbinscore", "4"],
    "sh_markers": ["seghaplotypes", "-i", "{d}/pg.sam", "-o",
                   "{d}/shm.bed", "-b", "2", "--minbinscore", "4", "-I",
                   "{d}/mk.csv", "-c", "5", "--alignbeds"],
    "sh_refmarkers": ["seghaplotypes", "-m", "1", "-i", "{d}/pg.sam",
                      "{d}/pg2.sam", "-o", "{d}/shr.bed", "-b", "1", "-I",
                      "{d}/refmk.csv", "-M", "0.45", "-t", "T", "-d",
                      "D"],
    "sh_nosplit": ["seghaplotypes", "-i", "{d}/pg.sam", "-o",
                   "{d}/shs.bed", "-b", "2", "--minbinscore", "4", "-s",
                   "-n"],
    "gbs_m0": ["gbsmapsnps", "-i", "{d}/gbs1.csv", "-I", "{d}/map2.csv",
               "-o", "{d}/hap1.csv"],
    "gbs_m0_nm": ["gbsmapsnps", "-i", "{d}/gbs2.csv", "-I",
                  "{d}/map3.csv", "-e", "7", "-o", "{d}/hap2.csv"],
    "gbs_m0_nomap": ["gbsmapsnps", "-i", "{d}/gbs1.csv", "-o",
                     "{d}/hap0.csv"],
    "gbs_m1": ["gbsmapsnps", "-m", "1", "-i", "{d}/hap1.csv", "-I",
               "{d}/hap3.csv", "-o", "{d}/comb.csv"],
    "dgts_m0": ["dgts", "-Q", "{d}/qtl.csv", "-I", "{d}/ref.pba.npz", "-i",
                "FA={d}/FA.pba.npz", "FB={d}/FB.pba", "P1={d}/P1.pba.npz",
                "P2={d}/P2.pba", "-o", "{d}/dq0.csv"],
    "dgts_m1": ["dgts", "-m", "1", "-Q", "{d}/qtl.csv", "-D",
                "{d}/m5.csv", "-I", "{d}/ref.pba.npz", "-i",
                *[f"{{d}}/{s}.pba.npz" for s in GROUP_SAMPLES[::3]],
                "-k", "0.5", "-p", "0.7", "-o", "{d}/dq1.csv"],
    "dgts_m1_noref": ["dgts", "-m", "1", "-Q", "{d}/qtl.csv", "-D",
                      "{d}/dgt.csv", "-i", "P2={d}/P2.pba",
                      "FA={d}/FA.pba.npz", "P3={d}/P3.pba.npz", "-o",
                      "{d}/dq2.csv"],
}
# gbsmapsnps -m 1 combines hap1.csv with this run's matrix
PRE_RUNS = {"gbs_m1": ["gbsmapsnps", "-i", "{d}/gbs3.csv", "-I",
                       "{d}/map2.csv", "-o", "{d}/hap3.csv"]}


def dirac(codes: np.ndarray) -> np.ndarray:
    """Bases -> PBA bytes of one allele at score 3 (0 where not A/C/G/T),
    as `pbautils -m 1` writes an assembly."""
    codes = np.asarray(codes)
    ok = codes < 4
    out = np.zeros(len(codes), np.uint8)
    out[ok] = (3 << SHIFTS[codes[ok]]).astype(np.uint8)
    return out


def skim(rng, alleles: list[np.ndarray], cover: float = 0.6) -> np.ndarray:
    """A skim-coverage PBA of the union of `alleles` (base codes, one array
    an allele set): each locus covered with probability `cover`, each
    present allele at score 1-3."""
    n = len(alleles[0])
    out = np.zeros(n, np.uint8)
    for a in alleles:
        sc = rng.integers(1, 4, n).astype(np.uint8)
        out |= (sc << SHIFTS[np.minimum(a, 3)]).astype(np.uint8)
    out[rng.random(n) >= cover] = 0
    return out


def _moved(rng, codes, rate):
    """`codes` with a share `rate` of its loci moved to another base."""
    out = codes.copy()
    sel = rng.random(len(codes)) < rate
    out[sel] = (out[sel] + rng.integers(1, 4, int(sel.sum()))) % 4
    return out


def workload() -> dict:
    """Every input of the golden (module docstring), as numpy arrays and
    text: built from numpy seeds and the port's host modules."""
    rng = np.random.default_rng(SEED)
    genome = {c: rng.integers(0, 4, n).astype(np.uint8) for c, n in CHROMS}
    hap = {"FA": genome,
           "FB": {c: _moved(rng, g, 0.08) for c, g in genome.items()},
           "FC": {c: _moved(rng, g, 0.08) for c, g in genome.items()}}
    pbas = {}
    for f in FOUNDERS:
        pbas[f] = {c: dirac(g) for c, g in hap[f].items()}
        for c, p in pbas[f].items():
            p[rng.integers(0, len(p), 40)] = 0
    A, B = hap["FA"], hap["FB"]
    mosaic = {   # per chromosome: (start, end, haplotype names)
        "P1": [("c1", 0, 12_000, "A"), ("c1", 12_000, 27_000, "B"),
               ("c1", 27_000, 40_000, "A"), ("c2", 0, 9_000, "B")],
        "P2": [("c1", 0, 8_000, "B"), ("c1", 8_000, 20_000, "AB"),
               ("c1", 20_000, 40_000, "B"), ("c2", 0, 9_000, "A")],
        "P4": [("c1", 0, 40_000, "A"), ("c2", 0, 9_000, "A")],
    }
    # P3 switches at random bin by bin over c1 [0, 10 kbp)
    p3 = [("c1", s, s + 500, "AB"[int(rng.integers(0, 2))])
          for s in range(0, 10_000, 500)]
    mosaic["P3"] = p3 + [("c1", 10_000, 40_000, "B"), ("c2", 0, 9_000, "A")]
    for name in PROGENY:
        chroms = {c: np.zeros(n, np.uint8) for c, n in CHROMS}
        for c, s, e, which in mosaic[name]:
            srcs = [(A if h == "A" else B)[c][s:e] for h in which]
            chroms[c][s:e] = skim(rng, srcs)
        pbas[name] = chroms
    pbas["P4"]["c1"][21_000:21_500] = pbas["P4"]["c1"][21_000:21_500] | \
        skim(rng, [B["c1"][21_000:21_500]], 1.0)            # the outlier
    pbas["P4"]["c1"][:9_950] = 0          # bins under 1 % aligned: mode 9
    pbas["P4"]["c1"][30_000:39_990] = 0   # rejects, imputes, retro-imputes
    for i, s in enumerate(GROUP_SAMPLES):
        src = hap[FOUNDERS[i % 3]]
        chroms = {}
        for c, g in src.items():
            p = dirac(_moved(rng, g, 0.005))
            for at in rng.integers(0, len(p) - 60, 6):
                p[at:at + int(rng.integers(5, 60))] = 0        # gap runs
            chroms[c] = p
        pbas[s] = chroms
    # concat: unequal lengths, an extra chromosome, scores to merge
    pbas["X"] = {"c1": pbas["P1"]["c1"][:30_000], "c2": pbas["P2"]["c2"]}
    pbas["Y"] = {"c2": skim(rng, [genome["c2"], B["c2"]])[:8_000],
                 "c1": pbas["P3"]["c1"], "c9": skim(rng, [genome["c2"]])}
    cov = {c: p.copy() for c, p in pbas["S01"].items()}
    cov["c1"][:3] = cov["c1"][-3:] = 0xC0           # covered at both ends
    cov["c1"][3] = cov["c1"][-4] = 0
    cov["c2"][:1] = cov["c2"][-1:] = 0
    cov["c3"] = np.zeros(500, np.uint8)             # nothing covered
    pbas["cov"] = cov
    # the --refpba of pbautils and dgts: what `pbautils -m 1` means to
    # write (it drops the first locus of every chromosome after the
    # first, ROADMAP.md queue C; its own output is held as it is)
    pbas["ref"] = {c: dirac(g) for c, g in genome.items()}
    return dict(genome=genome, pbas=pbas, snps=_snp_rows(rng, genome),
                pg_sam=_pangenome_sam(rng, genome, B, 1),
                pg_sam2=_pangenome_sam(rng, genome, B, 2),
                gbs=_gbs_csvs(rng))


def _snp_rows(rng, genome) -> dict:
    """Per cultivar: SNP rows (chrom, loci, ref, {base: count}, total) for
    `align/snp.py`'s CSV."""
    g1 = genome["c1"]
    loci = sorted(set(rng.integers(30, 39_970, 60).tolist()))
    out = {"A": [], "B": [], "C": []}
    for i, p in enumerate(loci):
        ref = int(g1[p])
        alt, alt2 = (ref + 1) % 4, (ref + 2) % 4
        tot = int(rng.integers(4, 30))
        kind = i % 6
        out["B"].append(("c1", p, ref, {alt: tot - 1, ref: 1}, tot))
        if kind == 0:      # A fixed on another alt: a marker
            out["A"].append(("c1", p, ref, {alt2: tot}, tot))
        elif kind == 1:    # A impure: no marker
            out["A"].append(("c1", p, ref, {alt: tot // 2,
                                            ref: tot - tot // 2}, tot))
        elif kind == 2:    # A thin: below -m
            out["A"].append(("c1", p, ref, {alt: 3}, 3))
        elif kind == 3:    # C agrees with B
            out["C"].append(("c1", p, ref, {alt: tot}, tot))
        # kind 4, 5: only B has a row, A and C imputed reference-fixed
    g2 = genome["c2"]
    for p in (0, 2, len(g2) - 1):                    # chromosome ends
        ref = int(g2[p])
        out["B"].append(("c2", p, ref, {(ref + 3) % 4: 9}, 9))
        out["A"].append(("c2", p, ref, {(ref + 3) % 4: 5, ref: 4}, 9))
    out["B"].append(("cX", 5, 0, {1: 8}, 8))         # not in the genome
    return out


def _pangenome_sam(rng, genome, B, which: int) -> list[tuple]:
    """Records (qname, flag, rname, pos, seq) against FA|#c1 and FB|#c1:
    FA's reads on c1 [0, 6 kbp) and [14, 20 kbp), FB's on [4, 16 kbp), a
    few duplicates, unmapped and untagged records."""
    rows = []
    spans = [("FA|#c1", 0, 6_000, 60), ("FB|#c1", 4_000, 16_000, 90),
             ("FA|#c1", 14_000, 20_000, 40)]
    if which == 2:
        spans = [("FB|#c1", 0, 20_000, 50), ("FA|#c2", 0, 9_000, 30)]
    for rname, s, e, n in spans:
        src = B["c1"] if rname.startswith("FB") else \
            genome[rname.split("#")[1]]
        for p in np.sort(rng.integers(s, e - 80, n)).tolist():
            rows.append((rname, p + 1, src[p:p + 80]))
    rows += [rows[3], rows[7]]                      # duplicate loci
    rows.append(("c1", 100, genome["c1"][99:179]))  # untagged
    recs = [(f"r{which}_{i}", 0, r, p, s) for i, (r, p, s) in
            enumerate(rows)]
    recs.append((f"r{which}_u", 4, "*", 0, genome["c1"][:80]))
    return recs


def _gbs_csvs(rng) -> dict:
    """Three GBS SNP CSVs over one progeny set; aliases chrA, chrB."""
    calls = ["AA", "TT", "AT", "NA", "A", "GG", "", "ta"]
    head = "SNPID,Chrom,Loci,FounderA,FounderB,P1,P2,P3\n"
    out = {}
    for k in (1, 2, 3):
        lines = [head]
        for i in range(24):
            chrom = ("chrA", "chrB", "chrZ")[i % 3]
            loci = int(rng.integers(1, 12_000)) if i != 5 else 99_999
            fa, fb = ("AA", "TT") if i % 4 else ("CC", "CC")
            if i == 7:
                fa = "AG"                           # heterozygous founder
            cells = [calls[int(j)] for j in rng.integers(0, len(calls), 3)]
            lines.append(f"s{k}_{i},{chrom},{loci},{fa},{fb},"
                         f"{','.join(cells)}\n")
        lines.append(f"s{k}_short,chrA,5,AA,TT,AA\n")
        out[k] = "".join(lines)
    return out


def _sam_text(recs, chroms) -> str:
    from .. import dna
    lines = ["@HD\tVN:1.4\tSO:unsorted\n"]
    lines += [f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in chroms]
    for q, flag, r, p, seq in recs:
        s = dna.decode(seq)
        lines.append(f"{q}\t{flag}\t{r}\t{p}\t{0 if flag & 4 else 254}\t"
                     f"{'*' if flag & 4 else f'{len(s)}M'}\t*\t0\t0\t{s}\t"
                     f"{'I' * len(s)}\n")
    return "".join(lines)


def _snp_calls(rows):
    from ..align.snp import SnpCall
    calls = []
    for chrom, loci, ref, counts, tot in rows:
        c = np.zeros(5, np.int64)
        for b, n in counts.items():
            c[b] = n
        calls.append(SnpCall(chrom, loci, ref, c, tot,
                             tot - int(counts.get(ref, 0)), 0.01,
                             10.0 ** -(tot % 9 + 2)))
    return calls


def write_inputs(work, d: Path) -> None:
    """The workload's input files in `d`."""
    from ..align.snp import write_multisnps_csv, write_snps_csv
    from ..io.fasta import Genome
    from ..kmer.pba import save_pba, save_pba_ref
    genome = work["genome"]
    write_fasta(d / "g.fa", [SeqRecord(c, "", g) for c, g in genome.items()])
    for name, chroms in work["pbas"].items():
        names = list(chroms)
        g = Genome.from_records([SeqRecord(n, "", chroms[n]) for n in names])
        save_pba(d / f"{name}.pba.npz", g, np.concatenate(
            [np.append(chroms[n], np.uint8(0)) for n in names]),
            readset=name)
        save_pba_ref(d / f"{name}.pba", chroms, readset=name,
                     experiment="E15", ref_assembly="g")
    for cult, rows in work["snps"].items():
        write_snps_csv(d / f"{cult}.snps.csv", _snp_calls(rows))
    b = [r for r in work["snps"]["B"] if r[0] == "c1"]
    di = [("c1", (r0[1], r1[1]), {"AC": r0[4]}) for r0, r1 in
          zip(b[:-1], b[1:]) if r1[1] - r0[1] <= 3_000]
    tri = [("c1", (r0[1], r1[1], r2[1]), {"ACG": r1[4]}) for r0, r1, r2 in
           zip(b[:-2], b[1:-1], b[2:])]
    write_multisnps_csv(d / "b.disnp.csv", di, 2)
    write_multisnps_csv(d / "b.trisnp.csv", tri, 3)
    pg_chroms = [("FA|#c1", 40_000), ("FB|#c1", 40_000), ("FA|#c2", 9_000),
                 ("c1", 40_000)]
    (d / "pg.sam").write_text(_sam_text(work["pg_sam"], pg_chroms))
    (d / "pg2.sam").write_text(_sam_text(work["pg_sam2"], pg_chroms))
    (d / "refmk.csv").write_text(
        "Chrom,Loci,Ref,Parents\n" + "".join(
            f"anc:c1,{p},A,x\n" for p in range(150, 20_000, 700)))
    (d / "mk.csv").write_text(
        '"MarkerID","Chrom","Loci","RefBase","A","A_purity"\n' + "".join(
            f'{i},"c1",{p},"A","T",1.000\n'
            for i, p in enumerate(range(4_100, 16_000, 450), 1)))
    for k, text in work["gbs"].items():
        (d / f"gbs{k}.csv").write_text(text)
    (d / "map2.csv").write_text("alias,chrom\nchrA,c1\nchrB,c2\n")
    (d / "map3.csv").write_text('"FromChrom","ToChrom","Size"\n'
                                "chrA,c1,5000\nchrB,c2,9000\n")
    qtl = ['"Chrom","Loci","Ref","Alt"\n']
    for chrom, loci, ref, counts, _ in work["snps"]["B"][:20]:
        alt = max(counts, key=counts.get)
        qtl.append(f'"{chrom}",{loci},"{"ACGT"[ref]}","{"ACGT"[alt]}"\n')
    qtl.append("c2,10,C\nc1,39999,g,t\nc1,x,A,C\n")
    (d / "qtl.csv").write_text("".join(qtl))
    (d / "dgt.csv").write_text("c1,100,A\nc1,2500\n\"c2\",77,t\nc1,loci\n")


def inputs_sha256(work) -> str:
    h = hashlib.sha256()
    for c, g in work["genome"].items():
        h.update(c.encode() + g.tobytes())
    for name, chroms in work["pbas"].items():
        for c, p in chroms.items():
            h.update(f"{name}:{c}".encode() + p.tobytes())
    h.update(repr((work["snps"], work["gbs"])).encode())
    for key in ("pg_sam", "pg_sam2"):
        for q, flag, r, p, s in work[key]:
            h.update(f"{q}{flag}{r}{p}".encode() + s.tobytes())
    return h.hexdigest()


def run_cli(main, argv_t, d: Path) -> tuple[int, str]:
    """One argv template in `d` through `main`; (exit code, stdout)."""
    argv = [a.format(d=d) for a in argv_t]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _text_array(text) -> np.ndarray:
    data = text.encode() if isinstance(text, str) else text
    return np.frombuffer(data, np.uint8).copy()


def npz_arrays(path: Path) -> dict[str, np.ndarray]:
    """A PBA .npz's arrays by key, its names as newline-joined text."""
    with np.load(path, allow_pickle=True) as z:
        out = {}
        for k in z.files:
            a = z[k]
            if a.dtype == object or a.dtype.kind in "US":
                a = _text_array("\n".join(str(x) for x in a.reshape(-1)))
            out[k] = a
        return out


def collect(out: dict, name: str, d: Path, before: set) -> None:
    """The files a run wrote in `d` into `out`: text bytes with `d` written
    as {d} (seghaplotypes names its output path in its track lines), or a
    .npz's arrays."""
    for p in sorted(d.iterdir()):
        if p.name in before:
            continue
        if p.name.endswith(".npz"):
            for k, a in npz_arrays(p).items():
                out[f"npz:{name}:{p.name}:{k}"] = a
        else:
            out[f"cli:{name}:{p.name}"] = _text_array(
                p.read_bytes().replace(str(d).encode(), b"{d}"))


def compute(fns, work=None) -> dict[str, np.ndarray]:
    """Every array of the golden through `fns` (`port_fns` here, the JAX
    package's in tests/test_torch_haplotypes_golden.py)."""
    work = workload() if work is None else work
    out = {"inputs_sha256": np.asarray(inputs_sha256(work))}
    with tempfile.TemporaryDirectory(prefix="haplotypes_golden_") as tmp:
        d = Path(tmp)
        write_inputs(work, d)
        for name, argv_t in RUNS.items():
            if name in PRE_RUNS:
                fns.run(PRE_RUNS[name], d)
            before = set(p.name for p in d.iterdir())
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

    def calls(key):
        return [ln.split(",")[3].strip('"')
                for ln in text(key).splitlines()[1:]]
    miss = []
    if "FaFb" not in calls("cli:ch_m0:m0.P2.csv"):
        miss.append("P2's heterozygous run called FaFb")
    if text("cli:ch_m1:m1.P3.raw.csv") == text("cli:ch_m2:m2.P3.csv"):
        miss.append("the runs test re-calling P3's switching bins")
    if text("cli:ch_m1:m1.P4.raw.csv") == text("cli:ch_m1:m1.P4.csv"):
        miss.append("the outlier bin flipped")
    if "none" not in calls("cli:ch_m0:m0.P4.csv"):
        miss.append("an uncalled bin")
    if not any("x" in c for c in calls("cli:ch_m2_three:m2f3.P2.csv")):
        miss.append("a three-founder pair call")
    imp = [ln.split(",") for ln in
           text("cli:ch_m9:m9.imputation.csv").splitlines()[1:]]
    if not any(float(r[5]) > 0 for r in imp) or \
            not any(float(r[6]) > 0 for r in imp):
        miss.append("mode 9's imputed and rejected bins")
    if text("cli:ch_m9:m9.selected.csv") == \
            text("cli:ch_m9_prune:m9p.selected.csv"):
        miss.append("mode 9's pruning")
    if text("cli:ch_m12_none:m12n.csv") != "" or \
            text("cli:ch_m11_none:m11n.csv").count("\n") != 1:
        miss.append("regex filters that match nothing")
    if len(text("cli:ch_m5:m5.csv").splitlines()) < 3 or \
            len(text("cli:ch_m10:m10.csv").splitlines()) < 3:
        miss.append("DGTs and group K-mers found")
    if text("cli:ch_m3:m3.csv").count('"c2"') < 6:
        miss.append("several groups a bin")
    wig = text("cli:pu_coverage:cov.wig")
    if "chrom=c1 span=3\n1\t1" not in wig or "c3" in wig:
        miss.append("coverage runs at a chromosome's ends")
    lens = {k.split(":")[-1]: len(v) for k, v in out.items()
            if k.startswith("npz:pu_concat:") and ":chrom:" in k}
    if lens != {"c1": 40_000, "c2": 9_000, "c9": 9_000}:
        miss.append(f"concat's unequal lengths ({lens})")
    if ",5000," not in text("cli:gbs_m0_nm:hap2.csv"):
        miss.append("gbsmapsnps' clamp")
    for key in ("cli:dgts_m1:dq1.csv", "cli:dgts_m1_noref:dq2.csv"):
        if '",2,"' not in text(key) or '",1,"' not in text(key):
            miss.append(f"{key}: QTL and DGT loci")
    if text("cli:sh:sh.bed.FA.bed") == text("cli:sh_markers:shm.bed.FA.bed"):
        miss.append("seghaplotypes' marker boost")
    if "<DEL>" not in text("cli:pu_m7:del.vcf"):
        miss.append("deletion genotypes")
    return miss


def differing(out: dict, gold) -> list[str]:
    """Keys of the golden whose array `out` lacks or does not equal, and
    keys `out` has that the golden lacks."""
    bad = []
    for k in gold.keys():
        if k not in out:
            bad.append(k)
            continue
        a, b = np.asarray(out[k]), gold[k]
        if not (a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b)):
            bad.append(k)
    bad += [k for k in out if k not in gold.keys()]
    return sorted(set(bad))
