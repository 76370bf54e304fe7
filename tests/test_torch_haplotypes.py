"""The port's PBA and haplotype modules against the JAX package's, function
by function on seeded inputs and on inputs built to break each rule:
kmer.pba (both containers, cross-loaded; `concat_pba` with unequal
lengths either way; coverage runs at a chromosome's ends), kmer.pbautils2,
kmer.callhaplotypes (the exact runs-test CDF and its critical values at
every small n, the runs test's clamps, het imputation with two and three
founders, outlier flips, ties between founders), kmer.haplogroups
(`consensus_pba`'s modal ties, `diff_matrix`'s three affine-gap rules,
coverage mode and imputation, `group_at_distance`'s tie order,
`group_haplotypes`' search, DGTs, group K-mers, the writers),
kmer.allelescores (scores, regex filters that match nothing, the
filter-transform, imputation, pruning, selection), kmer.dgtqtl (every
diplotype byte; a reference PBA and the first sample standing in for
it), kmer.snpmarkers, kmer.gbs (every genotype text, the maps, combine,
reports and the QTL functions no command reaches), tools.snpsfmt,
tools.pangenes (with `seg_haplotypes`, which no command reaches) and
tools.seghaps (with and without markers, unique and all loci). Every
comparison is exact: arrays bit for bit, files byte for byte.
"""
import dataclasses
import itertools
from pathlib import Path

import numpy as np
import pytest

from kit4b_tpu.kmer import allelescores as jas
from kit4b_tpu.kmer import callhaplotypes as jch
from kit4b_tpu.kmer import dgtqtl as jdq
from kit4b_tpu.kmer import gbs as jgbs
from kit4b_tpu.kmer import haplogroups as jhg
from kit4b_tpu.kmer import pba as jpba
from kit4b_tpu.kmer import pbautils2 as jpu
from kit4b_tpu.kmer import snpmarkers as jsm
from kit4b_tpu.tools import pangenes as jpg
from kit4b_tpu.tools import seghaps as jsh
from kit4b_tpu.tools import snpsfmt as jsf
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
from kit4b_tpu_torch.kmer import allelescores as pas
from kit4b_tpu_torch.kmer import callhaplotypes as pch
from kit4b_tpu_torch.kmer import dgtqtl as pdq
from kit4b_tpu_torch.kmer import gbs as pgbs
from kit4b_tpu_torch.kmer import haplogroups as phg
from kit4b_tpu_torch.kmer import pba as ppba
from kit4b_tpu_torch.kmer import pbautils2 as ppu
from kit4b_tpu_torch.kmer import snpmarkers as psm
from kit4b_tpu_torch.tools import make_haplotypes_golden as mg
from kit4b_tpu_torch.tools import pangenes as ppg
from kit4b_tpu_torch.tools import seghaps as psh
from kit4b_tpu_torch.tools import snpsfmt as psf


def plain(x):
    """Dataclasses, tuples and dicts down to comparable Python values;
    arrays to (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(vars(x)))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    return x


def same(jfn, pfn, *args, **kw):
    """Both functions on the same arguments give the same result."""
    want, got = jfn(*args, **kw), pfn(*args, **kw)
    assert plain(got) == plain(want)
    return got


def same_files(tmp_path, jfn, pfn, *args, suffix="out", **kw):
    """Both writers on the same arguments write the same bytes."""
    jp, pp = tmp_path / f"j.{suffix}", tmp_path / f"p.{suffix}"
    rj, rp = jfn(jp, *args, **kw), pfn(pp, *args, **kw)
    assert plain(rp) == plain(rj)
    assert pp.read_bytes() == jp.read_bytes()
    return pp


@pytest.fixture(scope="module")
def work():
    return mg.workload()


@pytest.fixture(scope="module")
def files(tmp_path_factory, work):
    d = tmp_path_factory.mktemp("haplotypes")
    mg.write_inputs(work, d)
    return d


# --- kmer.pba -------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pba_containers_cross_load(tmp_path, work, writer):
    """A PBA written by either package, in either container, is read by
    the other with arrays equal; `load_pba_any` picks the container by its
    magic, `unpack_pba` agrees on every byte value."""
    chroms = work["pbas"]["P2"]
    w, r = (ppba, jpba) if writer == "port" else (jpba, ppba)
    w.save_pba_ref(tmp_path / "x.pba", chroms, readset="rs", experiment="E",
                   ref_assembly="asm")
    g = Genome.from_records([SeqRecord(c, "", p) for c, p in chroms.items()])
    w.save_pba(tmp_path / "x.pba.npz", g, np.concatenate(
        [np.append(p, np.uint8(0)) for p in chroms.values()]), readset="rs")
    for path in (tmp_path / "x.pba", tmp_path / "x.pba.npz"):
        rs, got = r.load_pba_any(path)
        assert rs == "rs" and list(got) == list(chroms)
        for c, p in chroms.items():
            assert got[c].dtype == np.uint8
            np.testing.assert_array_equal(got[c], p)
    assert plain(r.load_pba_ref(tmp_path / "x.pba")) == \
        plain(w.load_pba_ref(tmp_path / "x.pba"))
    allb = np.arange(256, dtype=np.uint8)
    same(jpba.unpack_pba, ppba.unpack_pba, allb)


def test_pba_ref_rejects_other_versions(tmp_path, work):
    p = tmp_path / "v2.pba"
    jpba.save_pba_ref(p, work["pbas"]["FA"])
    p.write_bytes(p.read_bytes().replace(b"Version:1", b"Version:2", 1))
    for mod in (jpba, ppba):
        with pytest.raises(ValueError, match="unsupported PBA version"):
            mod.load_pba_any(p)


@pytest.mark.parametrize("order", ["XY", "YX", "XX"])
def test_concat_pba_unequal_lengths(files, tmp_path, order):
    """Same-chromosome PBAs merged by the max score of each allele; the
    longer input's tail kept whichever comes first; new chromosomes
    appended in order."""
    paths = [files / f"{c}.pba.npz" for c in order]
    jpba.concat_pba(paths, tmp_path / "j.npz")
    ppba.concat_pba(paths, tmp_path / "p.npz")
    assert plain(ppba.load_pba(tmp_path / "p.npz")) == \
        plain(jpba.load_pba(tmp_path / "j.npz"))


@pytest.mark.parametrize("name", ["cov", "P1", "S00"])
@pytest.mark.parametrize("min_score", [1, 2, 3])
def test_pba_coverage_wig_runs_at_chromosome_ends(files, tmp_path, name,
                                                  min_score):
    p = same_files(tmp_path, lambda o: jpba.pba_coverage_wig(
        files / f"{name}.pba.npz", o, min_score),
        lambda o: ppba.pba_coverage_wig(files / f"{name}.pba.npz", o,
                                        min_score), suffix="wig")
    if name == "cov" and min_score == 3:
        text = p.read_text()
        assert "chrom=c1 span=3\n1\t1\n" in text
        assert "chrom=c1 span=3\n39998\t1\n" in text


# --- kmer.pbautils2 --------------------------------------------------------

def test_pbautils2_functions_match(files, tmp_path, work):
    pb = work["pbas"]
    g = Genome.load(files / "g.fa")
    same(jpu.fasta_to_pba, ppu.fasta_to_pba, g)
    allb = np.arange(256, dtype=np.uint8)
    same(jpu.consensus_haploid, ppu.consensus_haploid, allb)
    same(jpu._allele_scores, ppu._allele_scores, allb)
    chroms = {"all": allb, **pb["P3"]}
    same_files(tmp_path, lambda o: jpu.pba_to_fasta(chroms, o, line_len=60),
               lambda o: ppu.pba_to_fasta(chroms, o, line_len=60),
               suffix="fa")
    samples = {s: pb[s] for s in ("FA", "P1", "P2", "S03")}
    rows = same(jpu.pba_concordance, ppu.pba_concordance, samples)
    same(jpu.wig_concordance, ppu.wig_concordance, samples, min_cov=40)
    same_files(tmp_path, jpu.write_concordance_csv,
               ppu.write_concordance_csv, rows, suffix="csv")
    for mod in (jpu, ppu):      # no rows: no file
        mod.write_concordance_csv(tmp_path / "empty.csv", [])
        assert not (tmp_path / "empty.csv").exists()
    ref = pb["ref"]
    same_files(tmp_path, lambda o: jpu.allelic_vcf(ref, pb["P3"], o),
               lambda o: ppu.allelic_vcf(ref, pb["P3"], o), suffix="vcf")
    for kw in (dict(), dict(diplotype_only=True, min_het_prop=0.3),
               dict(deletions=True), dict(max_na_prop=0.0)):
        same_files(tmp_path, lambda o: jpu.genotype_vcf(ref, samples, o,
                                                        **kw),
                   lambda o: ppu.genotype_vcf(ref, samples, o, **kw),
                   suffix="gt.vcf")
    same_files(tmp_path, lambda o: jpu.transcribed_bed(samples, o,
                                                       min_len=20),
               lambda o: ppu.transcribed_bed(samples, o, min_len=20),
               suffix="bed")


# --- kmer.callhaplotypes ---------------------------------------------------

def test_runs_test_cdf_and_critical_values_at_small_n():
    """The exact runs CDF and the too-few-runs critical values at every
    n1, n2 of the reference's table (2..20) and past it, each cached."""
    for n1, n2 in itertools.product(range(1, 22), repeat=2):
        assert pch.runs_crit_value(n1, n2) == jch.runs_crit_value(n1, n2)
        for r in (2, 3, n1 + n2 // 2, n1 + n2):
            assert pch._runs_cdf(n1, n2, r) == jch._runs_cdf(n1, n2, r)
    assert pch.runs_crit_value(2, 2, 0.5) == jch.runs_crit_value(2, 2, 0.5)
    hits = pch.runs_crit_value.cache_info().hits
    assert pch.runs_crit_value(7, 9) == jch.runs_crit_value(7, 9)
    assert pch.runs_crit_value.cache_info().hits == hits + 1
    for n_fa, n_fb, runs in itertools.product((1, 2, 5, 20, 21),
                                              (0, 2, 9, 20, 21),
                                              (0, 1, 2, 4, 9, 30, 42)):
        assert pch.is_random_haplotypes(n_fa, n_fb, runs) == \
            jch.is_random_haplotypes(n_fa, n_fb, runs)


def _calls(mod, labels, chrom="c1", step=1000):
    return [mod.BinCall(chrom if i < 30 else "c2", i * step,
                        i * step + step, lab, {"FA": i, "FB": 1}, 5)
            for i, lab in enumerate(labels)]


@pytest.mark.parametrize("labels", [
    "ABABBABAABABBAAB" + "A" * 10,             # random switching
    "AAAAAAAAABBBBBBBBBB",                      # one switch
    "AAHBAABHAABBAAHHBA",                       # het bins boost runs
    "AAABAAAnAAAnBnAB",                         # outliers and none
    "ABABAB" * 6,                               # across chromosomes
])
@pytest.mark.parametrize("window", [1_000_000, 4_000])
def test_imputation_rules_match(labels, window):
    names = {"A": "FA", "B": "FB", "H": "FaFb", "n": "none"}
    lab = [names[c] for c in labels]
    for imp in (lambda m, c: m.impute_heterozygosity(c, ("FA", "FB"),
                                                     window),
                lambda m, c: m.impute_outliers(c, window)):
        assert plain(imp(pch, _calls(pch, lab))) == \
            plain(imp(jch, _calls(jch, lab)))
    three = [c.replace("H", "X") for c in labels]
    lab3 = [{"A": "FA", "B": "FB", "X": "FAxFC", "n": "none"}[c]
            for c in three]
    assert plain(pch.impute_heterozygosity(_calls(pch, lab3),
                                           ("FA", "FB", "FC"), window)) == \
        plain(jch.impute_heterozygosity(_calls(jch, lab3),
                                        ("FA", "FB", "FC"), window))


@pytest.mark.parametrize("founders", [("FA", "FB"), ("FB", "FA"),
                                      ("FA", "FB", "FC")])
@pytest.mark.parametrize("kw", [dict(), dict(bin_size=777, min_loci=1,
                                             het_ratio=0.5),
                                dict(smooth=False), dict(ww_prox_window=0)])
def test_call_haplotypes_matches(files, tmp_path, founders, kw):
    fpaths = {f: files / f"{f}.pba{'' if f == 'FB' else '.npz'}"
              for f in founders}
    for prog in ("P2.pba", "P3.pba.npz"):
        raw_j, cj = jch.call_haplotypes(files / prog, fpaths,
                                        return_raw=True, **kw)
        raw_p, cp = pch.call_haplotypes(files / prog, fpaths,
                                        return_raw=True, **kw)
        assert plain((raw_p, cp)) == plain((raw_j, cj))
        for w in ("write_haplotype_calls",):
            same_files(tmp_path, getattr(jch, w), getattr(pch, w), cj)
        same_files(tmp_path, jch.write_haplotypes_gwas,
                   pch.write_haplotypes_gwas, raw_j, founders)
        same_files(tmp_path, jch.write_haplotype_matrix,
                   pch.write_haplotype_matrix, {"r": raw_j, "c": cj},
                   founders)
    with pytest.raises(ValueError):
        pch.call_haplotypes(files / "P1.pba.npz", {"FA": fpaths["FA"]})
    same_files(tmp_path, jch.write_haplotype_calls, pch.write_haplotype_calls,
               [], suffix="empty")


def test_call_haplotypes_tie_goes_to_the_later_founder(tmp_path):
    """Equal exclusive support: the bin calls the later founder."""
    a = np.array([0xC0, 0x30] * 50, np.uint8)
    b = np.array([0x30, 0xC0] * 50, np.uint8)
    prog = np.where(np.arange(100) < 50, a, b) | np.uint8(0)
    paths = {}
    for n, p in (("FA", a), ("FB", b), ("P", prog)):
        paths[n] = tmp_path / f"{n}.pba"
        jpba.save_pba_ref(paths[n], {"c": p})
    cj = jch.call_haplotypes(paths["P"], {"FA": paths["FA"],
                                          "FB": paths["FB"]}, smooth=False,
                             het_ratio=1.1)
    cp = pch.call_haplotypes(paths["P"], {"FA": paths["FA"],
                                          "FB": paths["FB"]}, smooth=False,
                             het_ratio=1.1)
    assert plain(cp) == plain(cj) and cp[0].call == "FB"


# --- kmer.haplogroups ------------------------------------------------------

def _group_matrix(work, chrom="c2", lo=0, hi=3000):
    return np.stack([work["pbas"][s][chrom][lo:hi]
                     for s in mg.GROUP_SAMPLES])


def test_consensus_pba_modal_ties():
    """Equal runs keep the smallest byte (the first run of the sorted
    column); a longer later run wins."""
    m = np.array([[5, 9, 0, 7], [9, 5, 0, 7], [9, 5, 3, 1], [5, 1, 3, 1]],
                 np.uint8)
    got = same(jhg.consensus_pba, phg.consensus_pba, m)
    assert got.tolist() == [5, 5, 0, 1]
    rng = np.random.default_rng(3)
    same(jhg.consensus_pba, phg.consensus_pba,
         rng.integers(0, 4, (7, 5000)).astype(np.uint8) * 0x40)


@pytest.mark.parametrize("affine", [-1, 0, 1, 3, 50])
@pytest.mark.parametrize("coverage", [False, True])
def test_diff_matrix_affine_gap_rules(work, affine, coverage):
    """Runs of relative gaps: scored in full (< 0), not at all (0), or in
    their first `affine` loci (> 0); with imputation every locus scores."""
    m = _group_matrix(work, hi=1500)
    m[2, 100:180] = 0                       # a gap run longer than 50
    m[5, 90:120] = 0                        # overlapping another
    m[7, -4:] = 0                           # at the bin's end
    got = same(jhg.diff_matrix, phg.diff_matrix, m,
               coverage_mode=coverage, affine_gap_len=affine)
    assert (got == got.T).all() and not np.diag(got).any()
    same(jhg.diff_matrix, phg.diff_matrix, m, coverage_mode=coverage,
         affine_gap_len=affine, impute=jhg.consensus_pba(m))


def test_group_at_distance_tie_order():
    """Rows covering as many unassigned samples tie on the smallest
    difference sum, then on the lowest row (np.lexsort is stable); a row
    covering none falls back to the first unassigned sample."""
    d = np.array([[0, 2, 2, 9, 9, 9],
                  [2, 0, 2, 9, 9, 9],
                  [2, 2, 0, 9, 9, 9],
                  [9, 9, 9, 0, 1, 9],
                  [9, 9, 9, 1, 0, 9],
                  [9, 9, 9, 9, 9, 0]], np.int64)
    for dist in (0, 1, 2, 8, 9):
        same(jhg.group_at_distance, phg.group_at_distance, d, dist)
    rng = np.random.default_rng(11)
    r = rng.integers(0, 4, (9, 9))
    r = r + r.T
    np.fill_diagonal(r, 0)
    for dist in range(0, 8):
        same(jhg.group_at_distance, phg.group_at_distance, r, dist)
    neg = np.full((3, 3), 5)
    same(jhg.group_at_distance, phg.group_at_distance, neg, 1)


@pytest.mark.parametrize("kw", [dict(), dict(min_dist=3, max_dist=3),
                                dict(min_dist=40, max_dist=20),
                                dict(max_groups=1), dict(max_groups=12)])
def test_group_haplotypes_search(work, kw):
    m = _group_matrix(work)
    d = jhg.diff_matrix(m, impute=jhg.consensus_pba(m))
    same(jhg.group_haplotypes, phg.group_haplotypes, d, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(coverage_mode=True),
                                dict(phases=1, max_groups=2),
                                dict(max_dist=None, min_dist=1)])
def test_grouping_dgts_kmers_and_writers_match(work, tmp_path, kw):
    m = _group_matrix(work)
    hj = jhg.gen_haplotype_groups(m, "c2", 0, **kw)
    hp = phg.gen_haplotype_groups(m, "c2", 0, **kw)
    assert plain(hp) == plain(hj)
    for dk in (dict(min_members=3), dict(min_members=3, max_report=5),
               dict(min_members=40), dict(min_members=3, fbeta=2.0,
                                          min_fmeasure=0.5)):
        dj = jhg.bin_dgts(hj, m, **dk)
        assert plain(phg.bin_dgts(hp, m, **dk)) == plain(dj)
    same_files(tmp_path, jhg.write_dgts_csv, phg.write_dgts_csv, dj)
    for kk in (dict(min_members=3, kmer_size=16), dict(
            min_members=3, kmer_size=9, max_nocov=1, min_hamming=1),
            dict(kmer_size=5000), dict(min_members=99)):
        assert plain(phg.group_kmers(hp, m, **kk)) == \
            plain(jhg.group_kmers(hj, m, **kk))
    names = list(mg.GROUP_SAMPLES)
    same_files(tmp_path, jhg.report_groups_csv, phg.report_groups_csv,
               [hj, hj], names)
    same_files(tmp_path, jhg.groupings_to_wig, phg.groupings_to_wig,
               [hj, dataclasses.replace(hj, chrom="c9")], track="t")


# --- kmer.allelescores -----------------------------------------------------

@pytest.mark.parametrize("bin_size", [0, 1, 999, 10_000, 100_000])
def test_score_pair_bins_match(work, bin_size):
    pb = work["pbas"]
    same(jas.score_pair_bins, pas.score_pair_bins, pb["P3"]["c1"],
         pb["FB"]["c1"][:30_000], bin_size)
    allb = np.repeat(np.arange(256, dtype=np.uint8), 256)
    same(jas.score_pair_bins, pas.score_pair_bins, allb,
         np.tile(np.arange(256, dtype=np.uint8), 256), bin_size)


def test_allele_scores_filters_and_grouping_match(work, tmp_path):
    pb = work["pbas"]
    refs = {f: pb[f] for f in ("FA", "FB", "FC")}
    srcs = {p: pb[p] for p in mg.PROGENY}
    scores = tmp_path / "s.csv"
    for s in (srcs, {}):
        same_files(tmp_path, lambda o: jas.gen_allele_scores(
            refs, s, o, bin_size=10_000), lambda o: pas.gen_allele_scores(
            refs, s, o, bin_size=10_000), suffix="csv")
    jas.gen_allele_scores(refs, srcs, scores, bin_size=10_000)
    same(jas.read_score_csv, pas.read_score_csv, scores)
    for kw in (dict(), dict(src_res=["P[13]"]), dict(ref_res=["^FB$"],
               chrom_res=["c2"]), dict(src_res=["nothing"]),
               dict(chrom_res=["nothing", "alsonot"])):
        for f in ("filter_allele_scores", "filter_transform_allele_scores"):
            same_files(tmp_path, lambda o: getattr(jas, f)(scores, o, **kw),
                       lambda o: getattr(pas, f)(scores, o, **kw),
                       suffix=f)
    sj, sp = jas.load_score_bins(scores), pas.load_score_bins(scores)
    assert plain(sp) == plain(sj)
    jas.impute_score_bins(sj)
    pas.impute_score_bins(sp)
    assert plain(sp) == plain(sj)
    assert {int(x) for x in np.unique(sp.state)} == \
        {pas.ACCEPTED, pas.IMPUTED, pas.NOT_ACCEPTED}
    for lo, hi in ((1, 4), (1, 1), (2, 2), (3, 1), (0, 9)):
        pj = jas.prune_references(sj, lo, hi)
        assert plain(pas.prune_references(sp, lo, hi)) == plain(pj)
        same(jas.select_references, pas.select_references, sj, pj)
    for kw in (dict(), dict(min_unpruned=1, max_unpruned=2)):
        jr = jas.group_allele_scores(scores, tmp_path / "gj", **kw)
        pr = pas.group_allele_scores(scores, tmp_path / "gp", **kw)
        assert plain(pr) == plain(jr)
        for ext in (".csv", ".selected.csv", ".imputation.csv",
                    ".imputation.summary.csv"):
            assert (tmp_path / f"gp{ext}").read_bytes() == \
                (tmp_path / f"gj{ext}").read_bytes()
    empty = tmp_path / "e.csv"
    empty.write_text(jas.SCORE_HEADER + "\n")
    for mod in (jas, pas):
        with pytest.raises(ValueError, match="no score rows"):
            mod.load_score_bins(empty)


# --- kmer.dgtqtl, kmer.gbs, kmer.snpmarkers ----------------------------------

def test_diplotypes_and_dgt_qtl_loaders_match(files):
    for b in range(256):
        assert pdq.diplotype_txt(b) == jdq.diplotype_txt(b)
    same(jdq.load_qtl_alleles, pdq.load_qtl_alleles, files / "qtl.csv")
    same(jdq.load_dgt_loci, pdq.load_dgt_loci, files / "dgt.csv")
    same(jdq.load_dgt_loci, pdq.load_dgt_loci, files / "qtl.csv")


@pytest.mark.parametrize("ref", ["reference", "first sample"])
@pytest.mark.parametrize("mode", [0, 1])
def test_analyse_dgt_qtls_matches(work, files, tmp_path, ref, mode):
    """With a reference PBA, and without one: the first sample stands in,
    as `dgts` without --refpba has it."""
    pb = work["pbas"]
    samples = {s: pb[s] for s in ("P2", "FA", "S03", "cov", "Y")}
    insts = jdq.load_qtl_alleles(files / "qtl.csv") + \
        jdq.load_dgt_loci(files / "dgt.csv")
    insts.append({"chrom": "c1", "loci": 500, "ref": "C", "alt": "G",
                  "qtl": True, "dgt": True})
    r = pb["ref"] if ref == "reference" else samples["P2"]
    for kw in (dict(), dict(min_coverage=0.3, homoz_prop=0.5)):
        rows = same(jdq.analyse_dgt_qtls, pdq.analyse_dgt_qtls, insts, r,
                    samples, mode=mode, **kw)
        same_files(tmp_path, jdq.write_dgt_qtl_csv, pdq.write_dgt_qtl_csv,
                   rows)


def test_gbs_functions_match(files, tmp_path, work):
    texts = ["", "na", "NA", "a", "T", "tt", "AC", "ca", "GN", "XG", "g-"]
    texts += ["".join(p) for p in itertools.product("ACGTN", repeat=2)]
    for s in texts:
        for major in (False, True):
            assert pgbs.snps_to_alleles(s, major) == \
                jgbs.snps_to_alleles(s, major)
    for m in ("map2.csv", "map3.csv"):
        cmap = same(jgbs.load_chrom_map, pgbs.load_chrom_map, files / m)
        for k in (1, 2, 3):
            res = same(jgbs.map_gbs_snps, pgbs.map_gbs_snps,
                       files / f"gbs{k}.csv", cmap)
    same(jgbs.map_gbs_snps, pgbs.map_gbs_snps, files / "gbs1.csv")
    founders, progenies, rows = res
    same_files(tmp_path, jgbs.write_haplotype_matrix,
               pgbs.write_haplotype_matrix, founders, progenies, rows,
               expr_id=3)
    jgbs.write_haplotype_matrix(tmp_path / "m2.csv", founders, progenies,
                                rows[::2])
    same(jgbs.read_haplotype_matrix, pgbs.read_haplotype_matrix,
         tmp_path / "j.out")
    same_files(tmp_path, lambda o: jgbs.combine_matrices(
        tmp_path / "j.out", tmp_path / "m2.csv", o),
        lambda o: pgbs.combine_matrices(tmp_path / "j.out",
                                        tmp_path / "m2.csv", o),
        suffix="comb")
    jrep = jgbs.write_progeny_reports(tmp_path / "rj", founders, progenies,
                                      rows, expr_id=4)
    prep = pgbs.write_progeny_reports(tmp_path / "rp", founders, progenies,
                                      rows, expr_id=4)
    assert list(prep.values()) == list(jrep.values())
    for pj, pp in zip(jrep, prep):
        assert open(pp, "rb").read() == open(pj, "rb").read()
    # the dgts QTL core, which no command reaches
    q = tmp_path / "q.csv"
    q.write_text('"Chrom","Loci","Allele"\nc1,10,A\n"c2",77,"g"\nc1,5,N\n'
                 "chrom,1,A\nc9,3,T\n")
    qtls = same(jgbs.load_qtl_csv, pgbs.load_qtl_csv, q)
    pb = work["pbas"]
    samples = {s: pb[s] for s in ("FA", "P2", "S04", "Y")}
    for kw in (dict(), dict(min_cov_prop=0.2, homoz_prop=0.5)):
        res = same(jgbs.analyse_qtls, pgbs.analyse_qtls, qtls, samples, **kw)
        same_files(tmp_path, jgbs.write_qtl_csv, pgbs.write_qtl_csv, res)


@pytest.mark.parametrize("kw", [dict(), dict(min_cov=10, min_purity=0.95),
                                dict(min_cov=1, min_purity=0.5,
                                     require_all_covered=True)])
def test_snp_markers_match(files, tmp_path, kw):
    csvs = {c: files / f"{c}.snps.csv" for c in ("A", "B", "C")}
    for c in csvs.values():
        same(jsm.load_snp_csv, psm.load_snp_csv, c)
    m = same(jsm.find_snp_markers, psm.find_snp_markers, csvs, **kw)
    same_files(tmp_path, jsm.write_snp_markers_csv,
               psm.write_snp_markers_csv, m, ["C", "A", "B", "D"])


# --- tools.snpsfmt, tools.pangenes, tools.seghaps ----------------------------

def test_snpsfmt_functions_match(files, tmp_path):
    from kit4b_tpu.io.fasta import Genome as JGenome
    for cult in ("A", "B"):
        snps = same(jsf.read_snps_csv, psf.read_snps_csv,
                    files / f"{cult}.snps.csv")
        for kw in (dict(), dict(track="t", assembly="a", min_count=30)):
            same_files(tmp_path, jsf.write_pgsnp, psf.write_pgsnp, snps,
                       suffix="pgsnp", **kw)
        for flank in (0, 1, 25, 10_000):
            m = jsf.marker_seqs(JGenome.load(files / "g.fa"), snps, flank)
            assert psf.marker_seqs(Genome.load(files / "g.fa"), snps,
                                   flank) == m
        same_files(tmp_path, jsf.write_marker_seqs_csv,
                   psf.write_marker_seqs_csv, m)
        for p in (0.0, 0.5, 0.97):
            gj, gp = JGenome.load(files / "g.fa"), Genome.load(files / "g.fa")
            assert psf.replace_assembly_alleles(gp, snps, min_prop=p) == \
                jsf.replace_assembly_alleles(gj, snps, min_prop=p)
            np.testing.assert_array_equal(gp.seq, gj.seq)
    for f in ("b.disnp.csv", "b.trisnp.csv"):
        same_files(tmp_path, lambda o: jsf.lochap_to_bed(files / f, o),
                   lambda o: psf.lochap_to_bed(files / f, o), suffix="bed")


def test_pangenes_functions_match(files, tmp_path):
    for r in ("FA|#c1", "|#c1", "c1", "A|#", "A|#b|#c", ""):
        assert ppg.split_founder(r) == jpg.split_founder(r)
    same_files(tmp_path, lambda o: jpg.prefix_fasta(files / "g.fa", o, "X"),
               lambda o: ppg.prefix_fasta(files / "g.fa", o, "X"),
               suffix="fa")
    for prefix in ("FA", "FB", "", "Z"):
        same_files(tmp_path, lambda o: jpg.filter_sam_prefix(
            files / "pg.sam", o, prefix), lambda o: ppg.filter_sam_prefix(
            files / "pg.sam", o, prefix), suffix="sam")
    for kbp, uniq in ((1, False), (3, True)):
        same_files(tmp_path, lambda o: jpg.binned_wiggle(
            files / "pg2.sam", o, kbp, uniq, "t"),
            lambda o: ppg.binned_wiggle(files / "pg2.sam", o, kbp, uniq,
                                        "t"), suffix="wig")
    # seg_haplotypes and its writer, which no command reaches
    sites = jsh.load_snpmarker_sites(files / "mk.csv")
    for kw in (dict(), dict(bin_kbp=2, min_bin_score=3, unique_loci=False),
               dict(bin_kbp=1, min_bin_score=2, marker_loci=sites,
                    marker_mult=7, min_bin_prop=0.6)):
        segs = same(jpg.seg_haplotypes, ppg.seg_haplotypes,
                    [files / "pg.sam", files / "pg2.sam"], **kw)
        same_files(tmp_path, jpg.write_segments_bed, ppg.write_segments_bed,
                   segs, track_name="n", track_descr="d", suffix="bed")


@pytest.mark.parametrize("markers", [None, "mk.csv", "refmk.csv"])
@pytest.mark.parametrize("kw", [dict(), dict(unique_loci=False),
                                dict(dont_score=True, no_split=True),
                                dict(bin_size_kbp=1, min_bin_prop=0.6,
                                     alignment_beds=True)])
def test_seghaplotypes_with_and_without_markers(files, tmp_path, markers,
                                                kw):
    """`run_seghaplotypes` with and without `-I` (both marker layouts),
    unique loci or all, split or not, scored or not."""
    mk = None if markers is None else str(files / markers)
    if mk:
        same(jsh.load_snpmarker_sites, psh.load_snpmarker_sites, mk)
    opts = dict(kw)
    bin_kbp = opts.pop("bin_size_kbp", 2)
    res = {}
    for pkg, mod in (("j", jsh), ("p", psh)):
        d = tmp_path / pkg
        d.mkdir()
        for s in ("pg.sam", "pg2.sam"):
            (d / s).write_bytes((files / s).read_bytes())
        r = mod.run_seghaplotypes([str(d / "pg.sam"), str(d / "pg2.sam")],
                                  str(d / "o.bed"), min_bin_score=3,
                                  bin_size_kbp=bin_kbp, snp_markers=mk,
                                  **opts)
        res[pkg] = ({p.name: p.read_bytes().replace(str(d).encode(), b"")
                     for p in sorted(d.iterdir())},
                    plain({k: v for k, v in r.items()
                           if k not in ("beds", "align_beds")}),
                    {Path(k).name: v for k, v in r["beds"].items()},
                    {Path(k).name: v for k, v in r["align_beds"].items()})
    assert res["p"][1:] == res["j"][1:]
    assert res["p"][0] == res["j"][0] and len(res["p"][0]) >= 3


def test_runs_test_spreads_a_switch_bins_fafb():
    """A bin that straddles a switch has support from both founders and is
    called FaFb; its two runs and both counts make the runs test find
    random switching in the windows around it (a few bins of the other
    founder give a critical value of 2), and the second pass at a fifth of
    the window spreads the FaFb calls over whole segments. Both packages
    do so (ROADMAP.md queue C); chip_smoke.py 17b measures it."""
    s = "A" * 30 + "H" + "B" * 25 + "H" + "A" * 40 + "H" + "B" * 20
    names = {"A": "FA", "B": "FB", "H": "FaFb"}
    out = {}
    for key, mod in (("j", jch), ("p", pch)):
        calls = _calls(mod, [names[c] for c in s], step=10_000)
        for w in (1_000_000, 200_000):
            calls = mod.impute_heterozygosity(calls, ("FA", "FB"), w)
        out[key] = plain(mod.impute_outliers(calls))
    assert out["p"] == out["j"]
    homo = [c for c, x in zip(out["p"], s) if x != "H"]
    fafb = sum(c[1]["call"] == "FaFb" for c in homo)
    assert fafb > 0.5 * len(homo)
