"""The seeded workload of the host-tools golden file and the arrays it
holds: every alignment-block, region, RAD-seq, loci-statistics,
DNA-structure and GO command of the command line (`genmafalgn`, `hypers`,
`loci2phylip`, `remaploci`, `genwiggle`, `locateroi`, `filtchrom`,
`gendeseq`, `radseq`, `loci2core`, `ref2relloci`, `genalignstats`,
`genalignconf`, `ssr`, `wigutils`, `gengoterms`, `gengoassoc`, `goassoc`,
`fasta2struct`, `fasta2dist`, `prednucleosomes`, `simulatemnase`,
`loci2dist`, `gennucstats`, `genloci2gene`, `gencomposition`,
`genrollups`, `genseqcandidates`, `genzygosity`, `fastafilter`,
`filterreads`, `genstructprofile`, `genstructstats`, `predconfnucs`,
`dnasitepotential`, `rnasitepotential`, `genelementseq`,
`genelementprofiles`, `gencentroidmetrics` and `proccentroids`), each
mode and each flag that picks another code path, through the command line.

`kit4b_tpu_torch/data/hosttools_golden.npz` holds the JAX package's
answers on this workload; `python tests/test_torch_hosttools_golden.py`
regenerates it (JAX on the CPU, seconds). A machine without JAX rebuilds
the same inputs with `workload()` and `write_inputs()` (numpy and the
port's own host modules: the `.kix` and the `.algn.npz` inputs are the
port's, both formats the packages share), runs the port with
`compute(port_fns(), work)` and compares with `differing()`: that is how
the port is held to the JAX package on the card.

The workload (`workload()`):

- a genome of three chromosomes (c1 5 kbp, c2 3 kbp, c3 1.2 kbp) with N
  runs, planted tandem repeats of units 1-5 (a unit that is itself a
  tandem of a shorter period included) and segments copied between
  chromosomes with and without substitutions; its `.kix` (lut_k 8);
- a MAF of three species over c1 and c2 (gaps, N, '-' strand rows, a
  block without the third species, a one-row block, conserved cores with
  and without mismatching columns) and its `.algn.npz`;
- loci CSVs (both strands, a chromosome the genome lacks, a header and a
  short row), their BED, an outspecies CSV with region bits, matches and
  mismatches, gene models (BED12 and BED6, both strands), feature and
  remapping BEDs;
- SAMs with @SQ headers (mapped, unmapped and off-dictionary records;
  two samples for gendeseq; MNase fragments stacked on planted dyads,
  paired with TLEN and single of about 147 bp);
- RAD-seq P1 reads of twelve loci (depths 4-14, a SNP in two, a paralog
  sharing one locus' restriction-site prefix, reads with three errors)
  and their P2 mates;
- two WIG tracks (fixedStep with step and span, variableStep, a float
  value, a chromosome in one track only);
- a GO OBO (three namespaces, alt_id, an obsolete term, a Typedef
  stanza), a GAF and a two-column association CSV, a sample and a
  population list;
- structure sequences (short ones, N bases), an octamer parameter table
  covering their octamers (quotes, a header, bad rows) and a two-column
  one, centroid count CSVs, a FASTA with long N runs and repeated ids.

The file holds each command's output files' bytes (`cli:<run>:<path>`,
the run directory written as {d}); a file of more than `BIG` bytes (the
65,536 octamers `genstructstats` writes, `*sitepotential`'s table) as its
SHA-256 and its length (`sha:<run>:<path>`), so the comparison stays byte
for byte and the golden small; the arrays of each `.npz` written
(`npz:<run>:<path>:<key>`, string arrays as newline-joined text), the
text a command prints (`stdout:<run>`) and the SHA-256 of the inputs.
"""
from __future__ import annotations

import hashlib
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..io.fasta import SeqRecord, write_fasta
from .make_convert_golden import _codes, _loci_csv, _outspecies, files
from .make_haplotypes_golden import (_sam_text, _text_array, differing,
                                     npz_arrays, run_cli)

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "hosttools_golden.npz"
SEED = 1717
CHROMS = (("c1", 5_000), ("c2", 3_000), ("c3", 1_200))
BIG = 65_536          # bytes: larger outputs are kept as SHA-256 and size
RAD_LOCI, RAD_LEN, RAD_P2 = 12, 90, 320

# the commands, in order: name -> argv, with {d} the working directory
RUNS = {
    # io/malign.py, tools/hypers.py, tools/convert.py through cli.py
    "genmafalgn": ["genmafalgn", "-i", "{d}/aln.maf", "-o",
                   "{d}/m0.algn.npz"],
    "genmafalgn_ref": ["genmafalgn", "-i", "{d}/aln.maf", "-o",
                       "{d}/m1.algn.npz", "-r", "mm"],
    "hypers": ["hypers", "-i", "{d}/aln.algn.npz", "-o", "{d}/hy.csv",
               "-l", "20"],
    "hypers_mm": ["hypers", "-i", "{d}/aln.algn.npz", "-o", "{d}/hy2.csv",
                  "-l", "15", "-X", "2", "-s", "3", "-O", "{d}/hys.csv",
                  "-b", "8"],
    "hypers_bed": ["hypers", "-i", "{d}/aln.algn.npz", "-o", "{d}/hy.bed",
                   "-l", "30"],
    "hypers_regions": ["hypers", "-i", "{d}/aln.algn.npz", "-o",
                       "{d}/hyr.csv", "-l", "10", "-X", "1", "-B",
                       "{d}/genes.bed", "-L", "300"],
    "loci2phylip": ["loci2phylip", "-i", "{d}/loci.csv", "-I",
                    "{d}/aln.algn.npz", "-o", "{d}/l.phy"],
    "loci2phylip_bed": ["loci2phylip", "-i", "{d}/loci.bed", "-I",
                        "{d}/aln.algn.npz", "-o", "{d}/lb.phy"],
    # tools/alignstats.py through cli_tools.py
    "loci2core": ["loci2core", "-i", "{d}/loci.csv", "-I",
                  "{d}/aln.algn.npz", "-o", "{d}/l2c.csv"],
    "loci2core_opts": ["loci2core", "-i", "{d}/loci.bed", "-I",
                       "{d}/aln.algn.npz", "-o", "{d}/l2c2.csv", "-s",
                       "hs,rn", "-m", "5", "-M", "300", "-d", "4"],
    "ref2relloci": ["ref2relloci", "-i", "{d}/loci.csv", "-I",
                    "{d}/aln.algn.npz", "-o", "{d}/r2r.csv"],
    "ref2relloci_sp": ["ref2relloci", "-i", "{d}/loci.csv", "-I",
                       "{d}/aln.algn.npz", "-o", "{d}/r2r2.csv", "-s",
                       "hs rn", "-l", "5", "-L", "600"],
    "alignstats_m0": ["genalignstats", "-i", "{d}/aln.algn.npz", "-o",
                      "{d}/as0.csv"],
    "alignstats_m1": ["genalignstats", "-m", "1", "-i", "{d}/aln.algn.npz",
                      "-o", "{d}/as1.csv", "-M", "3"],
    "alignstats_m2": ["genalignstats", "-m", "2", "-i", "{d}/aln.algn.npz",
                      "-o", "{d}/as2.csv"],
    "alignstats_sp": ["genalignstats", "-m", "2", "-i", "{d}/aln.algn.npz",
                      "-o", "{d}/as3.csv", "-s", "hs,rn"],
    "alignconf": ["genalignconf", "-i", "{d}/aln.algn.npz", "-o",
                  "{d}/ac0.csv"],
    "alignconf_chrom": ["genalignconf", "-i", "{d}/aln.algn.npz", "-o",
                        "{d}/ac1.csv", "-c", "-z", "3", "-x", "80"],
    "alignconf_one": ["genalignconf", "-m", "1", "-i", "{d}/aln.algn.npz",
                      "-o", "{d}/ac2.csv", "-C", "c2", "-Z", "2", "-X",
                      "250"],
    # align/regions.py, tools/remap.py through cli.py
    "genwiggle": ["genwiggle", "-i", "{d}/reads.sam", "-o", "{d}/cov.wig"],
    "locateroi": ["locateroi", "-i", "{d}/reads.sam", "-o", "{d}/roi.bed"],
    "locateroi_opts": ["locateroi", "-i", "{d}/reads.sam", "-o",
                       "{d}/roi2.bed", "-c", "1", "-l", "20"],
    "filtchrom_in": ["filtchrom", "-i", "{d}/reads.sam", "-o",
                     "{d}/fc1.sam", "-Z", "c1"],
    "filtchrom_out": ["filtchrom", "-i", "{d}/reads.sam", "-o",
                      "{d}/fc2.sam", "-z", "c[23]", "cZ"],
    "filtchrom_both": ["filtchrom", "-i", "{d}/reads.sam", "-o",
                       "{d}/fc3.sam", "-Z", "2$", "-z", "c"],
    "gendeseq": ["gendeseq", "-s", "A={d}/a.sam", "B={d}/b.sam", "-b",
                 "{d}/feat.bed", "-o", "{d}/de.csv"],
    "remaploci_sam": ["remaploci", "-i", "{d}/reads.sam", "-I",
                      "{d}/remap.bed", "-o", "{d}/rm.sam"],
    "remaploci_bed": ["remaploci", "-i", "{d}/loci.bed", "-I",
                      "{d}/remap.bed", "-o", "{d}/rm.bed"],
    # assembly/radseq.py
    "radseq": ["radseq", "-i", "{d}/p1.fa", "-o", "{d}/st.fa", "-O",
               "{d}/st.vcf"],
    "radseq_low": ["radseq", "-i", "{d}/p1.fa", "-o", "{d}/st2.fa", "-O",
                   "{d}/st2.vcf", "-Z", "4", "-s", "3", "-z", "8"],
    "radseq_pe": ["radseq", "-i", "{d}/p1.fa", "-I", "{d}/p2.fa", "-o",
                  "{d}/st3.fa", "-Z", "5", "-y", "25"],
    # tools/ssr.py, tools/wigutils.py
    "ssr": ["ssr", "-i", "{d}/g.fa", "-o", "{d}/ssr.csv"],
    "ssr_bed": ["ssr", "-i", "{d}/g.fa", "-o", "{d}/ssr.bed", "-k", "1",
                "-K", "6", "-r", "3", "-R", "40"],
    "wig_sum": ["wigutils", "-i", "{d}/a.wig", "{d}/b.wig", "-o",
                "{d}/sum.wig"],
    "wig_mean_csv": ["wigutils", "-i", "{d}/a.wig", "{d}/b.wig", "-o",
                     "{d}/mean.csv", "-p", "mean"],
    "wig_min": ["wigutils", "-i", "{d}/a.wig", "{d}/b.wig", "-o",
                "{d}/min.wig", "-p", "min"],
    "wig_max_stats": ["wigutils", "-i", "{d}/a.wig", "{d}/b.wig", "-o",
                      "{d}/max.csv", "-p", "max", "-m", "stats"],
    "wig_one": ["wigutils", "-i", "{d}/b.wig", "-o", "{d}/one.wig"],
    "wig_one_stats": ["wigutils", "-i", "{d}/a.wig", "-o",
                      "{d}/one.csv", "-m", "stats"],
    # tools/go.py
    "gengoterms": ["gengoterms", "-i", "{d}/go.obo", "-o",
                   "{d}/terms.csv"],
    "gengoassoc": ["gengoassoc", "-i", "{d}/go.gaf", "-o",
                   "{d}/ga0.csv"],
    "gengoassoc_obo": ["gengoassoc", "-i", "{d}/assoc.csv", "-O",
                       "{d}/go.obo", "-o", "{d}/ga1.csv"],
    "goassoc": ["goassoc", "-i", "{d}/sample.txt", "-a", "{d}/go.gaf",
                "-o", "{d}/en0.csv"],
    "goassoc_obo": ["goassoc", "-i", "{d}/sample.txt", "-a", "{d}/go.gaf",
                    "-O", "{d}/go.obo", "-o", "{d}/en1.csv"],
    "goassoc_pop": ["goassoc", "-i", "{d}/sample.txt", "-a",
                    "{d}/assoc.csv", "-p", "{d}/pop.txt", "-O",
                    "{d}/go.obo", "-o", "{d}/en2.csv", "-c", "3"],
    # tools/conformation.py through cli.py
    "fasta2struct": ["fasta2struct", "-i", "{d}/struct.fa", "-I",
                     "{d}/oct.csv", "-o", "{d}/fs.csv"],
    "fasta2struct_groove": ["fasta2struct", "-i", "{d}/struct.fa", "-I",
                            "{d}/oct.csv", "-p", "minorgroove", "-o",
                            "{d}/fs2.csv"],
    "fasta2dist": ["fasta2dist", "-i", "{d}/struct.fa", "-I",
                   "{d}/oct.csv", "-o", "{d}/fd.csv"],
    "fasta2dist_props": ["fasta2dist", "-i", "{d}/struct.fa", "-I",
                         "{d}/oct.csv", "-p", "twist,roll,orchid", "-o",
                         "{d}/fd2.csv"],
    "prednuc_m0": ["prednucleosomes", "-i", "{d}/mnase.sam", "-o",
                   "{d}/pn0.bedgraph"],
    "prednuc_m1": ["prednucleosomes", "-i", "{d}/mnase.sam", "-m", "1",
                   "-M", "1", "-o", "{d}/pn1.bed", "-s", "2"],
    "prednuc_m2": ["prednucleosomes", "-i", "{d}/mnase.sam", "-m", "2",
                   "-M", "2", "-o", "{d}/pn2.csv"],
    "simulatemnase": ["simulatemnase", "-g", "{d}/g.fa", "-n", "12", "-o",
                      "{d}/mn.fa"],
    "simulatemnase_seed": ["simulatemnase", "-g", "{d}/struct.fa", "-n",
                           "8", "-r", "5", "-o", "{d}/mn2.fa"],
    # tools/locistats.py through cli_tools.py
    "loci2dist": ["loci2dist", "-i", "{d}/loci.csv", "-o", "{d}/ld0.csv"],
    "loci2dist_regions": ["loci2dist", "-i", "{d}/loci.csv", "-I",
                          "{d}/genes.bed", "-o", "{d}/ld1.csv", "-r",
                          "300", "-l", "20", "-L", "700"],
    "loci2dist_bed": ["loci2dist", "-i", "{d}/loci.bed", "-o",
                      "{d}/ld2.csv", "-s", "2"],
    "gennucstats": ["gennucstats", "-i", "{d}/loci.csv", "-o",
                    "{d}/ns0.json"],
    "gennucstats_sample": ["gennucstats", "-i", "{d}/loci.csv", "-I",
                           "{d}/near.csv", "-o", "{d}/ns1.json", "-b",
                           "60", "-s", "65", "--winddyad", "8", "-B",
                           "{d}/genes.bed", "-r", "400"],
    "genloci2gene": ["genloci2gene", "-b", "{d}/genes.bed", "-i",
                     "{d}/loci.csv", "-o", "{d}/lg0.csv"],
    "genloci2gene_opts": ["genloci2gene", "-b", "{d}/genes.bed", "-i",
                          "{d}/loci.csv", "-o", "{d}/lg1.csv", "-c", "150",
                          "-s", "1", "-a", "400", "-x", "7", "-y", "2",
                          "-z", "6", "--intergenic", "9", "-L", "100"],
    "gencomposition": ["gencomposition", "-i", "{d}/loci.csv", "-I",
                       "{d}/g.fa", "-o", "{d}/gc0.csv", "-K", "3"],
    "gencomposition_seq": ["gencomposition", "-m", "1", "-i",
                           "{d}/loci.bed", "-I", "{d}/g.fa", "-o",
                           "{d}/gc1.json", "-k", "2", "-K", "2", "-l", "50",
                           "-L", "400"],
    "gencomposition_genome": ["gencomposition", "-I", "{d}/g.fa", "-o",
                              "{d}/gc2.csv", "-k", "3", "-K", "4"],
    "rollups_m0": ["genrollups", "-i", "{d}/os.csv", "-o", "{d}/ru0.csv"],
    "rollups_m1": ["genrollups", "-i", "{d}/os.csv", "-o", "{d}/ru1.csv",
                   "-m", "1", "-c", "1"],
    "rollups_m2": ["genrollups", "-i", "{d}/loci.csv", "-o",
                   "{d}/ru2.csv", "-m", "2", "-c", "2", "-p"],
    "rollups_m3": ["genrollups", "-i", "{d}/os.csv", "-o", "{d}/ru3.csv",
                   "-m", "3", "-r", "3", "-c", "1"],
    "rollups_m4": ["genrollups", "-i", "{d}/os.csv", "-o", "{d}/ru4.csv",
                   "-m", "4", "-a", "30", "-P", "40", "-A", "35", "-k",
                   "80"],
    "rollups_ucsc": ["genrollups", "-i", "{d}/os.csv", "-o",
                     "{d}/ru5.csv", "-m", "1", "-c", "3", "-p"],
    "seqcandidates": ["genseqcandidates", "-i", "{d}/loci.csv", "-I",
                      "{d}/g.kix", "-o", "{d}/sc0.csv", "-b", "300", "-l",
                      "40"],
    "seqcandidates_opts": ["genseqcandidates", "-i", "{d}/loci.bed", "-I",
                           "{d}/g.kix", "-o", "{d}/sc1.csv", "-s", "20",
                           "-b", "200", "-l", "30", "-T", "60", "-u",
                           "-10", "-U", "25"],
    "zygosity_exact": ["genzygosity", "-i", "{d}/g.kix", "-o",
                       "{d}/zy0.csv", "-s", "0", "-z", "0.01"],
    "zygosity": ["genzygosity", "-i", "{d}/g.kix", "-o", "{d}/zy1.csv",
                 "-O", "{d}/zy1raw.csv", "-s", "2", "-l", "30", "-z",
                 "0.05"],
    "zygosity_cap": ["genzygosity", "-i", "{d}/g.kix", "-o",
                     "{d}/zy2.csv", "-s", "1", "-l", "20", "-x", "2",
                     "-n", "0", "-z", "0"],
    "fastafilter": ["fastafilter", "-i", "{d}/ff.fa", "-o", "{d}/ff0.fa"],
    "fastafilter_opts": ["fastafilter", "-i", "{d}/ff.fa", "-o",
                         "{d}/ff1.fa", "-n", "2", "-s", "_"],
    "fastafilter_rc": ["fastafilter", "-m", "1", "-i", "{d}/ff.fa", "-o",
                       "{d}/ff2.fa"],
    "filterreads": ["filterreads", "-i", "{d}/loci.csv", "-I",
                    "{d}/genes.bed", "-o", "{d}/fr_in.csv", "-O",
                    "{d}/fr_out.csv", "-r", "2,3"],
    "filterreads_opts": ["filterreads", "-i", "{d}/loci.bed", "-I",
                         "{d}/genes.bed", "-I", "{d}/genes6.bed", "-o",
                         "{d}/fr2_in.csv", "-O", "{d}/fr2_out.csv", "-s",
                         "1", "-r", "0", "-L", "200"],
    "filterreads_all": ["filterreads", "-i", "{d}/loci.csv", "-o",
                        "{d}/fr3_in.csv"],
    # tools/structextra.py through cli_tools.py
    "structprofile": ["genstructprofile", "-i", "{d}/struct.fa", "-p",
                      "{d}/oct.csv", "-o", "{d}/sp0.csv", "-b", "11.0",
                      "-d", "1.0", "-D", "1.0", "-e", "1.0"],
    "structprofile_first": ["genstructprofile", "-m", "1", "-n", "3", "-i",
                            "{d}/struct.fa", "-p", "{d}/oct.csv", "-o",
                            "{d}/sp1.csv", "-T", "200", "-u", "20"],
    "structprofile_random": ["genstructprofile", "-m", "2", "-n", "4",
                             "-i", "{d}/struct.fa", "-p", "{d}/oct.csv",
                             "-o", "{d}/sp2.csv", "-T", "0", "-b", "10.5",
                             "-d", "1.01", "-D", "1.005", "-e", "0.99"],
    "structstats": ["genstructstats", "-i", "{d}/oct2.csv", "-o",
                    "{d}/ss0.csv"],
    "structstats_sort": ["genstructstats", "-s", "-i", "{d}/oct2.csv",
                         "-o", "{d}/ss1.csv"],
    "predconfnucs": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                     "{d}/oct.csv", "-o", "{d}/pc0.bedgraph"],
    "predconfnucs_f1": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc1.bed", "-M", "1",
                        "-d", "1.01", "-D", "1.0", "-e", "1.0"],
    "predconfnucs_f2": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc2.csv", "-M", "2",
                        "-t", "run2", "-a", "0", "-A", "60"],
    "predconfnucs_f3": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc3.bedgraph", "-M", "3",
                        "-a", "5"],
    "predconfnucs_f4": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc4.bed", "-M", "4",
                        "-r", "{d}/sfeat.bed"],
    "predconfnucs_f5": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc5.csv", "-M", "5",
                        "-d", "1.01", "-D", "1.0", "-e", "1.0"],
    "predconfnucs_f6": ["predconfnucs", "-i", "{d}/struct.fa", "-I",
                        "{d}/oct.csv", "-o", "{d}/pc6.csv", "-M", "6"],
    "dnasitepotential": ["dnasitepotential", "-i", "{d}/sites.csv", "-I",
                         "{d}/g.fa", "-o", "{d}/dsp.csv"],
    "rnasitepotential": ["rnasitepotential", "-i", "{d}/sites.csv", "-I",
                         "{d}/struct.fa", "-o", "{d}/rsp.csv", "-s", "-"],
    "dnasitepotential_plus": ["dnasitepotential", "-i", "{d}/sites.csv",
                              "-I", "{d}/struct.fa", "-o", "{d}/dsp2.csv",
                              "-s", "+"],
    "elementseq": ["genelementseq", "-i", "{d}/loci.csv", "-a",
                   "{d}/g.fa", "-o", "{d}/es0.csv"],
    "elementseq_concat": ["genelementseq", "-i", "{d}/loci.bed", "-a",
                          "{d}/g.fa", "-o", "{d}/es1.fa", "-p", "1", "-m",
                          "20", "-M", "300"],
    "elementseq_multi": ["genelementseq", "-i", "{d}/loci.csv", "-a",
                         "{d}/g.fa", "-o", "{d}/es2.fa", "-p", "2", "-I",
                         "{d}/genes.bed", "-L", "150"],
    "elementseq_bits": ["genelementseq", "-i", "{d}/os.csv", "-a",
                        "{d}/g.fa", "-o", "{d}/es3.csv"],
    "elementprofiles": ["genelementprofiles", "-i", "{d}/sites.csv", "-I",
                        "{d}/genes.bed", "-o", "{d}/ep0.csv", "-n", "20"],
    "elementprofiles_tss": ["genelementprofiles", "-i", "{d}/sites.csv",
                            "-i", "{d}/loci.bed", "-I", "{d}/genes.bed",
                            "-o", "{d}/ep1.csv", "-n", "10", "-r", "1",
                            "-P", "1", "-l", "400"],
    "elementprofiles_tes": ["genelementprofiles", "-i", "{d}/sites.csv",
                            "-i", "{d}/sites.csv", "-I", "{d}/genes.bed",
                            "-o", "{d}/ep2.csv", "-n", "8", "-r", "2",
                            "-P", "2", "-s", "2", "-l", "300"],
    "centroid_aln": ["gencentroidmetrics", "-i", "{d}/aln.algn.npz", "-o",
                     "{d}/cm0.csv"],
    "centroid_aln3": ["gencentroidmetrics", "-i", "{d}/aln.algn.npz", "-o",
                      "{d}/cm1.csv", "-n", "3"],
    "centroid_genome": ["gencentroidmetrics", "-m", "1", "-i", "{d}/g.fa",
                        "-o", "{d}/cm2.csv", "-n", "3"],
    "centroid_overlap": ["gencentroidmetrics", "-m", "1", "-i",
                         "{d}/g.fa", "-o", "{d}/cm3.csv", "-z"],
    "proccentroids_m0": ["proccentroids", "-i", "{d}/cent_g.csv", "-o",
                         "{d}/pr0.csv"],
    "proccentroids_m1": ["proccentroids", "-m", "1", "-i",
                         "{d}/cent_a.csv", "-o", "{d}/pr1.csv"],
    "proccentroids_m2": ["proccentroids", "-m", "2", "-i",
                         "{d}/cent_g.csv", "-o", "{d}/pr2.csv"],
    "proccentroids_m3": ["proccentroids", "-m", "3", "-n", "3", "-i",
                         "{d}/cent_g3.csv", "-o", "{d}/pr3.csv"],
}


def _mutate(rng, codes: np.ndarray, n_subs: int) -> np.ndarray:
    out = codes.copy()
    for p in rng.choice(len(out), n_subs, replace=False):
        if out[p] < 4:
            out[p] = (out[p] + 1 + rng.integers(0, 3)) % 4
    return out


def _genome(rng) -> dict:
    g = {c: _codes(rng, n) for c, n in CHROMS}
    plant = {("c1", 500): "CA" * 8, ("c1", 3_000): "AGC" * 6,
             ("c1", 4_200): "TTAGG" * 6, ("c2", 800): "A" * 30,
             ("c2", 1_500): "ACAC" * 10, ("c3", 600): "GATA" * 6,
             ("c3", 300): "GT" * 3 + "C" + "GT" * 4}
    for (c, p), s in plant.items():
        g[c][p:p + len(s)] = dna.encode(s)
    g["c2"][2_000:2_400] = _mutate(rng, g["c1"][1_000:1_400], 8)
    g["c3"][800:1_000] = g["c1"][3_500:3_700]
    g["c1"][2_000:2_040] = dna.BASE_N
    g["c3"][100:103] = dna.BASE_N
    g["c2"][2_100] = dna.BASE_N
    return g


def _loci_rows(rng, n: int, first: int = 1) -> list[dict]:
    """Loci rows on the genome's chromosomes and one it lacks, a few
    past their chromosome's end, both strands."""
    rows = []
    for i in range(n):
        chrom, size = CHROMS[i % 3] if i % 13 != 12 else ("cX", 500)
        ln = int(rng.integers(5, 640))
        s = int(rng.integers(0, size - 4))
        rows.append({"srcid": first + i, "type": ("hyper", "ultra")[i % 2],
                     "species": "hs", "chrom": chrom, "start": s,
                     "end": s + ln - 1, "len": ln,
                     "strand": "-" if i % 3 == 1 else "+"})
    return rows


def _maf_blocks(rng, genome) -> list[dict]:
    """MAF blocks: hs (the reference, on the genome), mm and rn; each
    row {"src", "start", "strand", "size", "text"}."""
    blocks = []
    spans = [("c1", 100, 260), ("c1", 900, 1_200), ("c1", 1_980, 2_060),
             ("c1", 3_400, 3_520), ("c2", 50, 330), ("c2", 2_050, 2_200),
             ("c1", 4_500, 4_560)]
    for bi, (chrom, a, b) in enumerate(spans):
        ref = genome[chrom][a:b].copy()
        cols = [dna.decode(ref)]
        core = (len(ref) // 3, len(ref) // 3 + min(60, len(ref) // 3))
        rows = []
        for sp, rate in (("mm", 0.03), ("rn", 0.09)):
            if sp == "rn" and bi == 5:
                continue
            r = ref.copy()
            subs = rng.random(len(r)) < rate
            subs[core[0]:core[1]] = False
            if bi == 1 and sp == "mm":      # mismatching columns in a core
                subs[core[0] + 20] = subs[core[0] + 41] = True
            r[subs] = (r[subs] + 1) % 4
            rows.append((sp, r))
        text = {"hs": list(cols[0])}
        for sp, r in rows:
            text[sp] = list(dna.decode(r))
        # gaps: a deletion in rn, an insertion in mm (a gap in hs and rn)
        if "rn" in text and len(ref) > 100:
            for k in range(8, 12):
                text["rn"][k] = "-"
        if len(ref) > 150:
            ins = int(rng.integers(0, 4, 1)[0])
            pos = len(ref) - 30
            for sp in text:
                text[sp].insert(pos, "ACGT"[ins] if sp == "mm" else "-")
        if bi == 3:
            text["mm"][5] = "N"
        starts = {"hs": a, "mm": 10_000 + 1_000 * bi,
                  "rn": 500 + 700 * bi}
        strands = {"hs": "+", "mm": "+", "rn": "-" if bi % 2 else "+"}
        srcs = {"hs": f"hs.{chrom}", "mm": f"mm.chr{7 + bi % 2}",
                "rn": "rn.chrZ" if bi == 2 else f"rn.chr{bi + 1}"}
        order = ("hs", "mm", "rn") if bi != 4 else ("mm", "hs", "rn")
        blk = []
        for sp in order:
            if sp not in text:
                continue
            t = "".join(text[sp])
            blk.append({"src": srcs[sp], "start": starts[sp],
                        "strand": strands[sp],
                        "size": len(t) - t.count("-"), "text": t})
        blocks.append(blk)
    one = genome["c2"][2_500:2_540]
    blocks.append([{"src": "hs.c2", "start": 2_500, "strand": "+",
                    "size": 40, "text": dna.decode(one)}])
    return blocks


def _sam_reads(rng, genome, n: int) -> list[tuple]:
    """(qname, flag, rname, pos1, codes): mapped reads clustered on a few
    hot spots, unmapped ones and ones on a chromosome off the @SQ
    dictionary."""
    recs = []
    hot = [("c1", 700), ("c1", 4_100), ("c2", 1_200), ("c3", 500)]
    for i in range(n):
        if i % 17 == 5:
            recs.append((f"r{i}", 4, "*", 0, _codes(rng, 60)))
            continue
        if i % 29 == 7:
            recs.append((f"r{i}", 0, "cZ", 10, _codes(rng, 50)))
            continue
        ln = int(rng.integers(40, 100))
        if i % 3:
            c, h = hot[i % len(hot)]
            p = max(0, h + int(rng.integers(-60, 60)))
        else:
            c = CHROMS[i % 3][0]
            p = int(rng.integers(0, dict(CHROMS)[c] - ln))
        p = min(p, dict(CHROMS)[c] - 1)
        flag = 16 if i % 4 == 1 else 0
        recs.append((f"r{i}", flag, c, p + 1,
                     genome[c][p:p + ln].copy() if p + ln <= dict(CHROMS)[c]
                     else genome[c][p:].copy()))
    return recs


def _mnase_sam(rng) -> list[tuple]:
    """MNase fragments (qname, flag, rname, pos1, length, tlen) stacked
    on planted dyads: paired reads whose TLEN is about 147, single reads of
    about 147 bp, some too short or too long, unmapped ones."""
    recs = []
    dyads = [("c1", 800), ("c1", 1_300), ("c2", 600), ("c3", 700),
             ("c1", 2_600)]
    for di, (c, d) in enumerate(dyads):
        for k in range(5 + di):
            tlen = 147 + int(rng.integers(-12, 13))
            s = d - tlen // 2 + int(rng.integers(-2, 3))
            recs.append((f"p{di}_{k}", 99, c, s + 1, 50, tlen))
            if k % 3:        # the mate's own dyad (queue C) stacks lower
                recs.append((f"p{di}_{k}", 147, c, s + tlen - 49, 50,
                             -tlen))
            ln = 147 + int(rng.integers(-15, 16))
            s1 = d - ln // 2 + int(rng.integers(-1, 2))
            recs.append((f"s{di}_{k}", 0, c, s1 + 1, ln, 0))
    for k in range(6):
        recs.append((f"long{k}", 99, "c2", 1_000 + k, 60, 260))
        recs.append((f"short{k}", 0, "c1", 3_000 + 7 * k, 90, 0))
        recs.append((f"u{k}", 4, "*", 0, 40, 0))
    return recs


def _rad_reads(rng) -> tuple[list, list]:
    """P1 reads of RAD_LOCI loci and their P2 mates. A planted SNP takes a
    third of its stack's reads and a random error a position no other
    read of its locus has, so no column's two commonest bases tie."""
    loci = [_codes(rng, RAD_LEN) for _ in range(RAD_LOCI)]
    p2 = [_codes(rng, RAD_P2) for _ in range(RAD_LOCI)]
    para = loci[3].copy()          # a paralog sharing locus 3's key
    para[30:] = _codes(rng, RAD_LEN - 30)
    depths = [14, 12, 11, 10, 9, 13, 4, 6, 12, 10, 14, 8]
    free = [p for p in range(26, RAD_LEN - 6)
            if p not in (40, 50, 55, 60, 70)]
    r1, r2 = [], []
    for li, depth in enumerate(depths):
        err = rng.permutation(free)
        for k in range(depth):
            src = loci[li]
            if li == 3 and k % 2:
                src = para
            r = src[:RAD_LEN - int(rng.integers(0, 7))].copy()
            if li in (1, 8) and k % 3 == 0:
                r[50] = (r[50] + 2) % 4        # an in-stack SNP
            if li == 5 and k % 3 == 1:
                r[60] = (r[60] + 1) % 4
            if k == depth - 1 and li % 4 == 0:
                for p in (40, 55, 70):
                    r[p] = (r[p] + 1) % 4      # three errors: a reject
            elif rng.random() < 0.3 and err[k] < len(r):
                r[err[k]] = (r[err[k]] + 3) % 4
            name = f"rad{li}_{k}"
            r1.append((name + "/1", r))
            o = int(rng.integers(0, RAD_P2 - 80))
            r2.append((name + "/2", p2[li][o:o + 80].copy()))
    return r1, r2


def _go() -> dict:
    """GO terms (goid, name, namespace, parents, obsolete, alt_ids) and
    gene annotations."""
    terms = [
        ("GO:0000001", "biological_process", "biological_process", [],
         False, []),
        ("GO:0000002", "metabolic process", "biological_process",
         ["GO:0000001"], False, ["GO:0000902"]),
        ("GO:0000003", "cell cycle", "biological_process", ["GO:0000001"],
         False, []),
        ("GO:0000004", "lipid metabolism", "biological_process",
         ["GO:0000002"], False, []),
        ("GO:0000005", "sugar metabolism", "biological_process",
         ["GO:0000002"], False, []),
        ("GO:0000006", "mitosis", "biological_process", ["GO:0000003"],
         False, []),
        ("GO:0000007", "lipid transport", "biological_process",
         ["GO:0000004", "GO:0000010"], False, []),
        ("GO:0000008", "obsolete process", "biological_process", [], True,
         []),
        ("GO:0000010", "transport", "biological_process", ["GO:0000001"],
         False, []),
        ("GO:0000020", "molecular_function", "molecular_function", [],
         False, []),
        ("GO:0000021", "kinase activity", "molecular_function",
         ["GO:0000020"], False, []),
        ("GO:0000022", "ATP binding", "molecular_function",
         ["GO:0000020"], False, ["GO:0000922", "GO:0000923"]),
        ("GO:0000030", "cellular_component", "cellular_component", [],
         False, []),
        ("GO:0000031", "nucleus", "cellular_component", ["GO:0000030"],
         False, []),
        ("GO:0000032", "membrane", "cellular_component", ["GO:0000030"],
         False, []),
    ]
    # gene -> direct terms; g1..g60, the sample g1..g16
    genes = {}
    leaf = {"GO:0000004": range(1, 10), "GO:0000005": range(20, 26),
            "GO:0000006": list(range(2, 6)) + list(range(30, 36)),
            "GO:0000007": range(1, 7), "GO:0000021": range(8, 15),
            "GO:0000922": range(40, 44), "GO:0000031": range(3, 16),
            "GO:0000032": range(44, 60), "GO:0000010": [11, 50],
            "GO:0000008": [12, 13], "GO:0099999": [5, 41],
            "GO:0000003": [50]}
    for goid, ids in leaf.items():
        for i in ids:
            genes.setdefault(f"g{i}", []).append(goid)
    return {"terms": terms, "genes": genes,
            "sample": [f"g{i}" for i in range(1, 17)] + ["g999", "g3"],
            "population": [f"g{i}" for i in range(1, 56)]}


def _struct_seqs(rng) -> list[tuple]:
    """Structure sequences: AT-rich and GC-rich stretches, short ones,
    N bases."""
    out = []
    for i, n in enumerate((600, 420, 520, 300, 180, 120, 7, 460)):
        c = _codes(rng, n)
        if i in (0, 2):
            for a in range(40, n - 40, 97):
                c[a:a + 12] = rng.choice([0, 3], 12)
        if i == 3:
            c[100:104] = dna.BASE_N
        out.append((f"s{i}", c))
    return out


def workload() -> dict:
    """Every input of the golden (module docstring): numpy arrays and
    text, built from numpy seeds."""
    rng = np.random.default_rng(SEED)
    genome = _genome(rng)
    loci = _loci_rows(rng, 48)
    near = [{**e, "srcid": 500 + i,
             "start": e["start"] + int(rng.integers(-9, 10))}
            for i, e in enumerate(loci[::2])]
    sites = _loci_rows(rng, 120, first=1_000)
    for e in sites[::7]:
        e.update(chrom="c1", start=CHROMS[0][1] - 4, end=CHROMS[0][1] - 1,
                 len=4, strand="+")
    return dict(genome=genome, loci=loci, near=near, sites=sites,
                maf=_maf_blocks(rng, genome),
                sam=_sam_reads(rng, genome, 260),
                mnase=_mnase_sam(rng), rad=_rad_reads(rng), go=_go(),
                struct=_struct_seqs(rng),
                octs=rng.normal(size=(4 ** 8, 22)).astype(np.float32),
                outspecies=_outspecies(rng, loci)[0])


def _octamer_table(work) -> str:
    """The parameter rows of every octamer of the structure sequences and
    the genome (one orientation each: the loader fills the reverse
    complement), values from the workload's seeded table; a header, a
    quoted row, a short row, a bad octamer and a non-numeric row."""
    pow4 = (4 ** np.arange(7, -1, -1)).astype(np.int64)
    seen = set()
    for _, c in work["struct"]:
        c = np.asarray(c, np.int64)
        if len(c) < 8:
            continue
        win = np.lib.stride_tricks.sliding_window_view(c, 8)
        for i in (win[(win <= 3).all(axis=1)] @ pow4).tolist():
            rc = int(((3 - np.asarray(
                [(i >> (2 * (7 - p))) & 3 for p in range(8)]))[::-1]
                * pow4).sum())
            if rc not in seen:
                seen.add(i)
    base = np.array([34.3, 2.1, 0.1, 3.3, -0.2, 0.0, 34.0, 2.0, -0.1, 0.0,
                     -8.0, 11.1, 0.5, 0.2, 0.2, 0.3, 0.3, 0.2, 0.2, 0.3,
                     0.3, 0.4], np.float64)
    scale = np.array([1.5, 1.2, 0.6, 0.1, 0.3, 0.3, 1.5, 1.2, 0.3, 0.3,
                      1.0, 0.4, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05,
                      0.05, 0.05, 0.1])
    lines = ['"Octamer","Twist","Roll","Tilt","Rise","Slide","Shift",'
             '"..."\n']
    for k, i in enumerate(sorted(seen)):
        mer = "".join("ACGT"[(i >> (2 * (7 - p))) & 3] for p in range(8))
        v = base + scale * work["octs"][i].astype(np.float64)
        cells = ",".join(f"{x:.4f}" for x in v)
        lines.append(f"'{mer}',{cells}\n" if k % 50 == 3 else
                     f"{mer},{cells}\n")
    lines += ["ACGTACGN,1,2,3\n", "AC\n", "TTTTAAAA,x,y\n"]
    return "".join(lines)


def write_inputs(work, d: Path) -> None:
    """The workload's input files in `d`."""
    from ..index.sfx_index import SfxIndex
    from ..io.fasta import Genome
    from ..io.malign import MAlign
    from .structextra import gencentroidmetrics, write_centroid_metrics
    g = work["genome"]
    write_fasta(d / "g.fa", [SeqRecord(c, "", g[c]) for c, _ in CHROMS])
    genome = Genome.load(d / "g.fa")
    SfxIndex.build(genome).save(d / "g.kix.npz")
    (d / "g.kix.npz").rename(d / "g.kix")
    maf = ["##maf version=1 scoring=golden\n", "# a comment\n", "\n"]
    for bi, blk in enumerate(work["maf"]):
        maf.append(f"a score={1000.5 * (bi + 1)}\n" if bi % 3 else "a\n")
        for r in blk:
            maf.append(f"s {r['src']} {r['start']} {r['size']} "
                       f"{r['strand']} 50000 {r['text']}\n")
        maf.append("\n")
    (d / "aln.maf").write_text("".join(maf))
    ma = MAlign.from_maf(d / "aln.maf")
    ma.save(d / "aln.algn.npz")
    head = '"SrcID","ElType","Species","Chrom","StartLoci","EndLoci",' \
        '"Len","Strand"\n'
    (d / "loci.csv").write_text(head + _loci_csv(work["loci"]) +
                                "bad,row\n")
    (d / "near.csv").write_text(_loci_csv(work["near"]))
    (d / "sites.csv").write_text(_loci_csv(work["sites"]))
    (d / "loci.bed").write_text("track name=loci\n" + "".join(
        f'{e["chrom"]}\t{e["start"]}\t{e["end"] + 1}\tl{e["srcid"]}\t0\t'
        f'{e["strand"]}\n' for e in work["loci"][:36]) +
        "c1\t4000\t4100\tlminus\t0\t+\n")
    from .csvtools import write_outspecies_csv
    write_outspecies_csv(d / "os.csv", work["outspecies"])
    (d / "genes.bed").write_text(
        "c1\t200\t2200\tgA\t0\t+\t400\t2000\t0\t3\t500,400,600,\t"
        "0,900,1400,\n"
        "c1\t3000\t4200\tgB\t0\t-\t3100\t4100\t0\t2\t300,500,\t0,700,\n"
        "c2\t500\t1500\tgC\t0\t+\t500\t500\t0\t2\t200,300,\t0,700,\n"
        "c2\t2000\t2900\tgE\t0\t-\t2100\t2800\t0\t1\t900,\t0,\n"
        "c3\t100\t600\tgD\t0\t-\n")
    (d / "genes6.bed").write_text("c1\t4400\t4900\tgF\t0\t+\n"
                                  "c3\t700\t1100\tgG\t0\t+\n")
    (d / "feat.bed").write_text(
        "track name=feats\n"
        "c1\t600\t900\tfa\t0\t+\nc1\t4000\t4300\tfb\t0\t-\n"
        "c2\t1100\t1400\n"
        "c3\t400\t700\tfd\t5\t+\nc2\t0\t50\tfe\t0\t+\n"
        "cZ\t0\t100\tfz\t0\t+\n")
    (d / "remap.bed").write_text(
        "c1\t500\t1500\tscafA\t0\t+\nc1\t3900\t4400\tscafB\t0\t-\n"
        "c2\t1000\t1600\tscafC\t0\t+\nc3\t0\t600\tscafD\t0\t-\n")
    (d / "sfeat.bed").write_text("s0\t0\t300\tx\t0\t+\n"
                                 "s2\t200\t520\ty\t0\t-\n")
    chroms = [(c, n) for c, n in CHROMS]
    (d / "reads.sam").write_text(_sam_text(work["sam"], chroms))
    (d / "a.sam").write_text(_sam_text(work["sam"][::2], chroms))
    (d / "b.sam").write_text(_sam_text(work["sam"][1::2], chroms))
    mn = ["@HD\tVN:1.4\n"] + [f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in chroms]
    for q, flag, r, p, ln, tlen in work["mnase"]:
        s = "A" * ln
        mn.append(f"{q}\t{flag}\t{r}\t{p}\t{0 if flag & 4 else 60}\t"
                  f"{'*' if flag & 4 else f'{ln}M'}\t=\t0\t{tlen}\t{s}\t"
                  f"{'I' * ln}\n")
    (d / "mnase.sam").write_text("".join(mn))
    r1, r2 = work["rad"]
    write_fasta(d / "p1.fa", [SeqRecord(n, "", c) for n, c in r1])
    write_fasta(d / "p2.fa", [SeqRecord(n, "", c) for n, c in r2])
    (d / "a.wig").write_text(
        'track type=wiggle_0 name="a"\n# comment\n'
        "fixedStep chrom=c1 start=11 step=1\n3\n3\n4\n0\n7\n"
        "fixedStep chrom=c1 start=101 step=5 span=3\n1\n2\n2\n"
        "variableStep chrom=c2 span=4\n5\t2\n20\t6\n\n"
        "variableStep chrom=c2\n30\t1\n")
    (d / "b.wig").write_text(
        "browser position c1\n"
        "variableStep chrom=c1\n12\t2\n13\t2.5\n106\t4\n200\t1\n"
        "fixedStep chrom=c3 start=1 step=1 span=2\n9\n9\n1\n")
    (d / "bad.wig").write_text("5\nvariableStep chrom=c1\n3\t1\n")
    go = work["go"]
    obo = ["format-version: 1.2\n", "ontology: go\n", "\n"]
    for goid, name, ns, parents, obsolete, alts in go["terms"]:
        obo += ["[Term]\n", f"id: {goid}\n", f"name: {name}\n",
                f"namespace: {ns}\n"]
        obo += [f"alt_id: {a}\n" for a in alts]
        obo += [f"is_a: {p} ! parent\n" for p in parents]
        if obsolete:
            obo.append("is_obsolete: true\n")
        obo.append("\n")
    obo += ["[Typedef]\n", "id: part_of\n", "name: part of\n", "\n"]
    (d / "go.obo").write_text("".join(obo))
    gaf = ["!gaf-version: 2.1\n", "! a comment\n"]
    csv_rows = []
    for gene, goids in go["genes"].items():
        for goid in goids:
            gaf.append("\t".join(["DB", f"ID{gene}", gene, "", goid,
                                  "REF", "IEA", "", "P", gene, "",
                                  "protein", "taxon:1", "20240101", "DB",
                                  "", ""]) + "\n")
            csv_rows.append(f'"{gene}","{goid}"\n' if len(csv_rows) % 2
                            else f"{gene},{goid}\n")
    gaf.append("DB\tshort\trow\n\n")
    (d / "go.gaf").write_text("".join(gaf))
    (d / "assoc.csv").write_text("".join(csv_rows) + "lonely\n")
    (d / "sample.txt").write_text("\n".join(go["sample"]) + "\n\n")
    (d / "pop.txt").write_text("\n".join(go["population"]) + "\n")
    write_fasta(d / "struct.fa", [SeqRecord(n, "", c)
                                  for n, c in work["struct"]])
    (d / "oct.csv").write_text(_octamer_table(work))
    (d / "oct2.csv").write_text("".join(
        f"{''.join('ACGT'[(i >> (2 * (7 - p))) & 3] for p in range(8))},"
        f"{34 + work['octs'][i, 0]:.3f},{2 + work['octs'][i, 1]:.3f}\n"
        for i in range(0, 4 ** 8, 2_731)))
    ff = [SeqRecord("dup", "first", np.concatenate(
        [g["c1"][:40], np.full(15, dna.BASE_N, np.uint8), g["c1"][40:80]])),
        SeqRecord("dup", "second", g["c2"][:50]),
        SeqRecord("n", "", np.concatenate(
            [np.full(3, dna.BASE_N, np.uint8), g["c3"][:30],
             np.full(2, dna.BASE_N, np.uint8)])),
        SeqRecord("dup", "third", g["c3"][200:260])]
    write_fasta(d / "ff.fa", ff)
    ma_res = gencentroidmetrics(ma, nmer=5, mode=0)
    write_centroid_metrics(d / "cent_a.csv", ma_res)
    for n, name in ((5, "cent_g.csv"), (3, "cent_g3.csv")):
        write_centroid_metrics(d / name, gencentroidmetrics(
            None, nmer=n, mode=1, genome=genome, overlap=True))


def inputs_sha256(work) -> str:
    h = hashlib.sha256()
    for c, g in work["genome"].items():
        h.update(c.encode() + g.tobytes())
    h.update(repr([work[k] for k in ("loci", "near", "sites", "maf",
                                     "go", "outspecies")]).encode())
    for q, flag, r, p, s in work["sam"]:
        h.update(f"{q}{flag}{r}{p}".encode() + s.tobytes())
    h.update(repr(work["mnase"]).encode())
    for reads in work["rad"]:
        for n, c in reads:
            h.update(n.encode() + c.tobytes())
    for n, c in work["struct"]:
        h.update(n.encode() + c.tobytes())
    h.update(work["octs"].tobytes())
    return h.hexdigest()


def collect(out: dict, name: str, d: Path, before: set) -> None:
    """The files a run wrote under `d` into `out`: a .npz's arrays, a file
    of more than BIG bytes as its SHA-256 and length, else its bytes, the
    directory written as {d}."""
    for rel in sorted(files(d) - before):
        p = d / rel
        if rel.endswith(".npz"):
            for k, a in npz_arrays(p).items():
                out[f"npz:{name}:{rel}:{k}"] = a
            continue
        data = p.read_bytes().replace(str(d).encode(), b"{d}")
        if len(data) > BIG:
            out[f"sha:{name}:{rel}"] = _text_array(
                f"{hashlib.sha256(data).hexdigest()} {len(data)}")
        else:
            out[f"cli:{name}:{rel}"] = _text_array(data)


def compute(fns, work=None) -> dict[str, np.ndarray]:
    """Every array of the golden through `fns` (`port_fns` here, the JAX
    package's in tests/test_torch_hosttools_golden.py)."""
    work = workload() if work is None else work
    out = {"inputs_sha256": np.asarray(inputs_sha256(work))}
    with tempfile.TemporaryDirectory(prefix="hosttools_golden_") as tmp:
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

    def col(key, i, skip=1):
        return [ln.split(",")[i] for ln in rows(key)[skip:]]
    miss = []
    meta = rows("npz:genmafalgn:m0.algn.npz:__meta__")
    if len(meta) != 7 or not any(m.split("\t")[3] == "mm" for m in meta):
        miss.append("genmafalgn's one-row block and first-row reference")
    if text("npz:genmafalgn_ref:m1.algn.npz:__species__").split()[0] != \
            "mm":
        miss.append("genmafalgn -r")
    if '"chr7"' not in text("cli:hypers:hy.csv") or \
            not {"0"} < set(col("cli:hypers_mm:hy2.csv", 5)) or \
            len(set(col("cli:hypers_regions:hyr.csv", 8))) < 3:
        miss.append("hypers' reference chromosomes, mismatches, regions")
    if not rows("cli:hypers_mm:hys.csv")[1:] or \
            len(rows("cli:hypers_mm:hy2.csv")) <= len(rows(
                "cli:hypers:hy.csv")) or not rows("cli:hypers_bed:hy.bed"):
        miss.append("hypers -X -O")
    if "Sub:rn:" not in text("cli:alignstats_m2:as2.csv") or \
            "Sub:mm:" in text("cli:alignstats_sp:as3.csv"):
        miss.append("genalignstats' pairwise substitutions")
    if len(rows("cli:alignconf_chrom:ac1.csv")) < 3:
        miss.append("genalignconf per chromosome")
    for key in ("cli:loci2phylip:l.phy", "cli:loci2phylip_bed:lb.phy",
                "cli:loci2core_opts:l2c2.csv", "cli:ref2relloci:r2r.csv",
                "cli:ref2relloci_sp:r2r2.csv"):
        if len(rows(key)) < 3:
            miss.append(key)
    if len(rows("cli:locateroi_opts:roi2.bed")) <= len(rows(
            "cli:locateroi:roi.bed")) or not rows("cli:locateroi:roi.bed"):
        miss.append("locateroi's thresholds")
    fc = [len(rows(f"cli:filtchrom_{k}:fc{i}.sam"))
          for i, k in enumerate(("in", "out", "both"), 1)]
    if len(set(fc)) != 3:
        miss.append(f"filtchrom's include and exclude {fc}")
    if '"c2:1100-1400"' not in text("cli:gendeseq:de.csv"):
        miss.append("gendeseq's unnamed feature")
    if "scafB" not in text("cli:remaploci_bed:rm.bed") or \
            "scafD" not in text("cli:remaploci_sam:rm.sam"):
        miss.append("remaploci on a '-' feature")
    vcf = [ln for ln in rows("cli:radseq:st.vcf") if ln[0] != "#"]
    if len(vcf) < 2 or text("cli:radseq_low:st2.fa").count(">") <= \
            text("cli:radseq:st.fa").count(">") or \
            "_p2" not in text("cli:radseq_pe:st3.fa"):
        miss.append("radseq's variants, depths and P2 contigs")
    ssr, ssr1 = text("cli:ssr:ssr.csv"), text("cli:ssr_bed:ssr.bed")
    if '"c2",1500,1540,2,20,"AC"' not in ssr or '"ACAC"' in ssr or \
            '"c2",799' in ssr or "c2\t799\t830\tAx31" not in ssr1:
        miss.append("ssr's shorter-period rule and unit 1")
    if "\n0\n" not in text("cli:wig_min:min.wig") or \
            "2.5" not in text("cli:wig_one:one.wig"):
        miss.append("wigutils' min of a missing value, float values")
    for key in ("cli:goassoc:en0.csv", "cli:goassoc_obo:en1.csv",
                "cli:goassoc_pop:en2.csv"):
        p = col(key, 6)
        if len(p) < 5 or len(set(p)) != len(p):
            miss.append(f"{key}: tied or too few p-values {p}")
    if col("cli:goassoc_pop:en2.csv", 5) == col("cli:goassoc_obo:en1.csv",
                                                 5)[:len(col(
                                                     "cli:goassoc_pop:"
                                                     "en2.csv", 5))]:
        miss.append("goassoc -p")
    if "GO:0000902" in text("cli:gengoterms:terms.csv") or \
            ",1\n" not in text("cli:gengoterms:terms.csv"):
        miss.append("gengoterms' alt_id and obsolete terms")
    dy = [len(rows(f"cli:prednuc_m{m}:pn{m}.{x}"))
          for m, x in enumerate(("bedgraph", "bed", "csv"))]
    if min(dy) < 4 or len(set(dy)) < 2:
        miss.append(f"prednucleosomes' modes {dy}")
    if text("cli:simulatemnase:mn.fa").count(">") != 12 or \
            not 0 < text("cli:simulatemnase_seed:mn2.fa").count(">") < 8:
        miss.append("simulatemnase's short chromosomes")
    if '"Intron"' not in text("cli:loci2dist_regions:ld1.csv"):
        miss.append("loci2dist's regions")
    if '"n_matched": 0' in text("cli:gennucstats_sample:ns1.json"):
        miss.append("gennucstats' sample dyads")
    rel = set(col("cli:genloci2gene:lg0.csv", 5) +
              col("cli:genloci2gene_opts:lg1.csv", 5))
    if rel != {'"intergenic"', '"intragenic"', '"upstream"',
               '"downstream"'}:
        miss.append(f"genloci2gene's relationships {rel}")
    if max(map(int, col("cli:seqcandidates:sc0.csv", 11))) == 0:
        miss.append("genseqcandidates' multi-mapping subsequences")
    for key in ("cli:zygosity_exact:zy0.csv", "cli:zygosity:zy1.csv",
                "cli:zygosity_cap:zy2.csv"):
        if not any(ln.split(",")[0] != ln.split(",")[2] and
                   ln.split(",")[3] != "0" for ln in rows(key)):
            miss.append(f"{key}: no copy across chromosomes")
    if ",0,0.000000" not in text("cli:zygosity_cap:zy2.csv"):
        miss.append("genzygosity -z 0")
    ff = text("cli:fastafilter:ff0.fa") + text("cli:fastafilter_opts:ff1.fa")
    if ">dup.2" not in ff or ">dup_1" not in ff or "N" * 11 in ff:
        miss.append("fastafilter's names and N runs")
    if len(rows("cli:filterreads:fr_in.csv")) < 2 or \
            len(rows("cli:filterreads:fr_out.csv")) < 2:
        miss.append("filterreads' regions")
    sp = text("cli:structprofile:sp0.csv")
    if ",nan\n" not in sp or len(rows(
            "cli:structprofile_random:sp2.csv")) != 5:
        miss.append("genstructprofile's short sequence and sampling")
    if text("sha:structstats:ss0.csv") == text(
            "sha:structstats_sort:ss1.csv"):
        miss.append("genstructstats -s")
    pc = {f: len(rows(k)) for k in out if k.startswith("cli:predconfnucs")
          for f in [k.split(":")[1]]}
    if len(pc) != 7 or min(pc.values()) < 2 or \
            pc["predconfnucs_f4"] >= pc["predconfnucs_f3"] or \
            pc["predconfnucs_f1"] <= pc["predconfnucs"]:
        miss.append(f"predconfnucs' formats, ratios and regions {pc}")
    if col("cli:elementseq_bits:es3.csv", 7) == ["0"] * 48:
        miss.append("genelementseq's feature bits")
    for key in ("cli:elementprofiles:ep0.csv",
                "cli:elementprofiles_tss:ep1.csv",
                "cli:elementprofiles_tes:ep2.csv"):
        if sum(map(int, rows(key)[1].split(",")[1:])) == 0:
            miss.append(f"{key}: an empty profile")
    if max(map(int, col("cli:centroid_aln:cm0.csv", 2))) == 0:
        miss.append("gencentroidmetrics' mismatches")
    if len(rows("cli:centroid_overlap:cm3.csv")) <= len(rows(
            "cli:centroid_genome:cm2.csv")):
        miss.append("gencentroidmetrics -z")
    return miss
