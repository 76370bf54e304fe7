"""The port's scorers and the aligner's users against the JAX package's on
the CPU, on the inputs of tests/test_benchmark.py, test_magicbench.py,
test_longtail2.py::test_alignsbs, test_foundations.py::test_readstats,
test_tools.py::test_ngsqc_plot_rendering, test_bed.py::test_maploci and
test_rnade2.py, and on seeded ones: align/benchmark.py's `score_sam`,
align/magicbench.py (CIGAR helpers, observed profiles SE and PE, their CSV,
the replay's RNG stream, the ground truth and its scoring), align/
alignsbs.py (on the port's KAligner with device "cpu"), align/readstats.py
(the distributions, their CSVs and JSON, the contaminant counts, the
plots), io/bed.py's `map_loci_to_features` and align/rnade.py (binning,
bootstrap, classification, CSVs), each field, array or file equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from kit4b_tpu import dna as jdna
from kit4b_tpu.align import alignsbs as jsbs
from kit4b_tpu.align import benchmark as jbm
from kit4b_tpu.align import magicbench as jmb
from kit4b_tpu.align import readstats as jrs
from kit4b_tpu.align import rnade as jde
from kit4b_tpu.io import bed as jbed
from kit4b_tpu.io import biobed as jbio
from kit4b_tpu.io import fasta as jfa
from kit4b_tpu.io import sam as jsam
from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.align import alignsbs as psbs
from kit4b_tpu_torch.align import benchmark as pbm
from kit4b_tpu_torch.align import magicbench as pmb
from kit4b_tpu_torch.align import readstats as prs
from kit4b_tpu_torch.align import rnade as pde
from kit4b_tpu_torch.io import bed as pbed
from kit4b_tpu_torch.io import biobed as pbio
from kit4b_tpu_torch.io import fasta as pfa
from kit4b_tpu_torch.io import sam as psam
from kit4b_tpu_torch.tools import make_longtail_golden as mg


def _truth_name(i, chrom, start, L, strand, subs=0):
    return f"lcl|{i:08d}|{chrom}|{start}|{start+L-1}|{L}|{strand}|{subs}|0"


@pytest.fixture
def truth_sam(tmp_path):
    """tests/test_benchmark.py's five records, then secondary, paired,
    duplicate and truthless ones (the golden's mode-4 SAM)."""
    p = tmp_path / "t.sam"
    mg._sam(p, [("chrT", 30_000)], mg._bench_inputs(
        np.random.default_rng(0))[4])
    return p


@pytest.mark.parametrize("tolerance", [0, 2, 5, 500])
def test_score_sam_matches(truth_sam, tolerance):
    w = pbm.ScoreWeights(match=2.0, misaligned=-1.5)
    for kw in (dict(), dict(weights=w)):
        r = pbm.score_sam(truth_sam, tolerance=tolerance, **kw)
        j = jbm.score_sam(truth_sam, tolerance=tolerance, **(
            dict(weights=jbm.ScoreWeights(2.0, -1.5)) if kw else {}))
        assert dataclasses.asdict(r) == dataclasses.asdict(j)
        assert r.summary() == j.summary()
    assert r.n_reads == 9 and r.n_no_truth == 1


def test_score_sam_test_benchmark_case(tmp_path):
    p = tmp_path / "t.sam"
    with psam.SamWriter(p, ["c1"], [10_000]) as w:
        for i, (start, flag, pos1, cig) in enumerate([
                (100, 0, 101, "100M"), (300, 16, 301, "100M"),
                (500, 0, 901, "100M"), (700, 16, 701, "100M"),
                (900, 4, 0, "*")]):
            strand = "-" if i == 1 else "+"
            w.write(psam.SamAlignment(_truth_name(i + 1, "c1", start, 100,
                                                  strand), flag,
                                      "c1" if flag != 4 else "*", pos1,
                                      254 if flag != 4 else 0, cig))
    r = pbm.score_sam(p)
    assert dataclasses.asdict(r) == dataclasses.asdict(jbm.score_sam(p))
    assert (r.n_correct, r.n_loci_only, r.score) == (2, 1, -300)
    assert r.summary()["pct_correct_of_aligned"] == 50.0


@pytest.mark.parametrize("cigar", ["10=2X3I5D20=", "50M", "5S40M5S",
                                   "3H10M2N10M", "7=1X1P2=", "", "4M4I"])
def test_cigar_helpers_match(cigar):
    ops = pmb.parse_cigar(cigar)
    assert ops == jmb.parse_cigar(cigar)
    assert pmb.cigar_str(ops) == jmb.cigar_str(ops)
    for f in ("read_len_of", "ref_len_of"):
        assert getattr(pmb, f)(ops) == getattr(jmb, f)(ops)
    for sh in (False, True):
        assert pmb.potential_match_bases(ops, sh) == \
            jmb.potential_match_bases(ops, sh)
    rl = pmb.read_len_of(ops)
    np.testing.assert_array_equal(pmb.expand_ref_loci(ops, 100, rl),
                                  jmb.expand_ref_loci(ops, 100, rl))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The golden's benchmark inputs: the 30 kbp genome, SE and PE control
    SAMs and the FASTQ, written once."""
    d = tmp_path_factory.mktemp("bench")
    g, ctrl, ctrl_pe, raw, _ = mg._bench_inputs(np.random.default_rng(8))
    pfa.write_fasta(d / "g.fa", [pfa.SeqRecord("chrT", "", g)])
    mg._sam(d / "ctrl.sam", [("chrT", len(g))], ctrl)
    mg._sam(d / "ctrl_pe.sam", [("chrT", len(g))], ctrl_pe)
    pfa.write_fastq(d / "raw.fq", raw)
    return d


def _genomes(d):
    return pfa.Genome.load(d / "g.fa"), jfa.Genome.load(d / "g.fa")


@pytest.mark.parametrize("pe", [False, True])
def test_obs_cigars_and_replay_match(bench, tmp_path, pe):
    pg, jg = _genomes(bench)
    sam = bench / ("ctrl_pe.sam" if pe else "ctrl.sam")
    pp = pmb.gen_obs_cigars(sam, pg, pe=pe)
    jp = jmb.gen_obs_cigars(sam, jg, pe=pe)
    assert [dataclasses.asdict(p) for p in pp] == \
        [dataclasses.asdict(p) for p in jp]
    assert len(pp) >= (20 if pe else 60)
    assert len(pmb.gen_obs_cigars(sam, pg, pe=pe, max_reads=7)) == 7
    pmb.write_obs_cigars(tmp_path / "p.csv", pp, pe=pe)
    jmb.write_obs_cigars(tmp_path / "j.csv", jp, pe=pe)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    back, back_pe = pmb.read_obs_cigars(tmp_path / "p.csv")
    jback, jback_pe = jmb.read_obs_cigars(tmp_path / "p.csv")
    assert [dataclasses.asdict(p) for p in back] == \
        [dataclasses.asdict(p) for p in jback]
    assert back_pe == jback_pe == pe
    for seed in (1, 3, 99):
        ps, p2 = pmb.sim_reads_from_profiles(pg, back, 40, pe=pe,
                                             seed=seed)
        js, j2 = jmb.sim_reads_from_profiles(jg, back, 40, pe=pe, seed=seed)
        for a, b in ((ps, js), (p2, j2)):
            assert [(r.name, r.descr, r.codes.tolist()) for r in a] == \
                [(r.name, r.descr, r.codes.tolist()) for r in b]
        assert len(ps) == 40 and len(p2) == (40 if pe else 0)


@pytest.mark.parametrize("pe", [False, True])
def test_ground_truth_and_scoring_match(bench, tmp_path, pe):
    pg, _ = _genomes(bench)
    profs = pmb.gen_obs_cigars(bench / ("ctrl_pe.sam" if pe else
                                        "ctrl.sam"), pg, pe=pe)
    se, pe2 = pmb.sim_reads_from_profiles(pg, profs, 30, pe=pe, seed=4)
    pfa.write_fasta(tmp_path / "s1.fa", se)
    files = [tmp_path / "s1.fa"]
    rows = mg.sim_sam_rows(se)
    if pe:
        pfa.write_fasta(tmp_path / "s2.fa", pe2)
        files.append(tmp_path / "s2.fa")
        rows += mg.sim_sam_rows(pe2, shift_every=4, pe2=True)
    rows.append(("unknown", 0, "chrT", 5, "10M", "A" * 10))
    rows.append(("SR1", 0x100, "chrT", 5, "10M", "A" * 10))
    rows.append(("SR2", 4, "*", 0, "*", "A" * 10))
    mg._sam(tmp_path / "al.sam", [("chrT", 30_000)], rows)
    pgt, jgt = pmb.load_ground_truth(*files), jmb.load_ground_truth(*files)
    assert {k: dataclasses.asdict(v) for k, v in pgt.items()} == \
        {k: dataclasses.asdict(v) for k, v in jgt.items()}
    ps = pmb.score_alignments(tmp_path / "al.sam", pgt, pe=pe)
    js = jmb.score_alignments(tmp_path / "al.sam", jgt, pe=pe)
    a, b = dataclasses.asdict(ps), dataclasses.asdict(js)
    np.testing.assert_array_equal(a.pop("overlap_hist"),
                                  b.pop("overlap_hist"))
    assert a == b and ps.n_unscored == 1
    for fb in ((0.1, 0.1), (1.0, 0.5), (2.0, 3.0)):
        assert ps.measures(*fb) == js.measures(*fb)


def test_magicbench_test_case(tmp_path):
    """tests/test_magicbench.py's perfect aligner on the port: precision
    1, no incorrect bases, all reads scored."""
    g = pfa.Genome.from_records([pfa.SeqRecord(
        "chrT", "", np.random.default_rng(11).integers(0, 4, 30_000)
        .astype(np.uint8))])
    profs = [pmb.ObsProfile(1, 50, "+", "50M", "20=1X29="),
             pmb.ObsProfile(2, 50, "-", "50M", "10=2I5D33=")]
    se, _ = pmb.sim_reads_from_profiles(g, profs, 40, seed=3)
    pfa.write_fasta(tmp_path / "sim.fa", se)
    mg._sam(tmp_path / "al.sam", [("chrT", 30_000)],
            mg.sim_sam_rows(se, shift_every=0))
    sc = pmb.score_alignments(tmp_path / "al.sam",
                              pmb.load_ground_truth(tmp_path / "sim.fa"))
    m = sc.measures()
    assert sc.n_scored == 40 and sc.bases_incorrect == 0
    assert m["precision_bases"] == 1.0 and m["recall_bases"] > 0.99


@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_limit_reads_matches(bench, tmp_path, fmt):
    src = bench / "raw.fq"
    if fmt == "fa":
        pfa.write_fasta(tmp_path / "raw.fa", list(pfa.read_seqs(src)))
        src = tmp_path / "raw.fa"
    for n in (1, 20, 1_000):
        assert pmb.limit_reads(src, tmp_path / "p", n) == \
            jmb.limit_reads(src, tmp_path / "j", n)
        assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.fixture(scope="module")
def sbs(tmp_path_factory):
    """tests/test_longtail2.py::test_alignsbs's assembly, queries and
    targets."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    d = tmp_path_factory.mktemp("sbs")
    codes = np.random.default_rng(9).integers(0, 4, 20_000).astype(np.uint8)
    pfa.write_fasta(d / "asm.fa", [pfa.SeqRecord("c1", "", codes)])
    return d, codes


@pytest.mark.parametrize("kw", [
    dict(n_bootstraps=3, max_subs=0, seed=4, batch_size=64),
    dict(n_bootstraps=2, max_subs=3, seed=11, batch_size=16,
         sense_only=True)])
def test_bootstrap_align_matches(sbs, tmp_path, kw):
    d, codes = sbs
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = {}
        for name, mod, fa, extra in (
                ("port", psbs, pfa, dict(device="cpu")),
                ("jax", jsbs, jfa, {})):
            asm = fa.Genome.load(d / "asm.fa")
            q = [fa.SeqRecord(f"q{i}", "", codes[i * 500:i * 500 + 80])
                 for i in range(10)]
            t = [fa.SeqRecord(f"t{i}", "", codes[i * 1000:i * 1000 + 2000])
                 for i in range(8)]
            res[name] = mod.bootstrap_align(q, asm, t, asm, **kw, **extra)
            mod.write_bootstrap_csv(tmp_path / f"{name}.q",
                                    tmp_path / f"{name}.t", res[name])
    finally:
        torch.set_num_threads(n)
    assert [dataclasses.asdict(r) for r in res["port"]] == \
        [dataclasses.asdict(r) for r in res["jax"]]
    for ext in ("q", "t"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    orig = res["port"][0]
    assert len(res["port"]) == kw["n_bootstraps"] + 1
    assert orig.n_queries == 10 and orig.query_hits >= 8
    if not kw.get("sense_only"):
        assert all(r.query_hits >= 5 for r in res["port"][1:])


def test_bootstrap_without_cuda_refuses(sbs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kit4b_tpu_torch.device import DeviceUnavailable
    d, codes = sbs
    asm = pfa.Genome.load(d / "asm.fa")
    q = [pfa.SeqRecord("q0", "", codes[:80])]
    with pytest.raises(DeviceUnavailable):
        psbs.bootstrap_align(q, asm, q, asm, n_bootstraps=1)


def test_sampling_and_scoring_helpers_match():
    g = pfa.Genome.from_records([pfa.SeqRecord(
        n, "", np.random.default_rng(ln).integers(0, 4, ln)
        .astype(np.uint8)) for n, ln in (("a", 500), ("b", 3_000),
                                         ("c", 120))])
    jg = jfa.Genome(g.names, g.starts, g.lengths, g.seq)
    lens = np.array([100, 120, 121, 600, 5_000, 0, 3_000])
    got = psbs.sample_fragments(g, lens, np.random.default_rng(5))
    assert got == jsbs.sample_fragments(jg, lens, np.random.default_rng(5))
    starts = np.array([s for s, _ in got[:4]] + [-1, 40, 3_400], np.int64)
    for frags in (got, got[:2], []):
        assert dataclasses.asdict(psbs._score_iteration(
            2, starts, lens, frags)) == dataclasses.asdict(
            jsbs._score_iteration(2, starts, lens, frags))
    for needle in (g.seq[700:764], g.seq[:3], np.zeros(0, np.uint8),
                   np.array([3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3], np.uint8)):
        assert psbs._find_subseq(g.seq, needle) == \
            jsbs._find_subseq(g.seq, needle)


def _qc_records(fa):
    """tests/test_foundations.py::test_readstats's reads (its duplicate
    included), then the golden's ngsqc reads."""
    rng = np.random.default_rng(4)
    recs = [fa.SeqRecord(f"r{i}", "", rng.integers(0, 4, 80)
                         .astype(np.uint8), rng.integers(5, 40, 80)
                         .astype(np.uint8)) for i in range(50)]
    recs.append(fa.SeqRecord("dup", "", recs[0].codes.copy(),
                             recs[0].qual.copy()))
    recs += [fa.SeqRecord(r.name, r.descr, r.codes, r.qual)
             for r in mg._qc_reads(np.random.default_rng(6))]
    recs.append(fa.SeqRecord("noqual", "", rng.integers(0, 5, 30)
                             .astype(np.uint8)))
    return recs


@pytest.mark.parametrize("kmer_len", [1, 3, 5])
def test_readstats_match(tmp_path, kmer_len):
    ps = prs.compute_readstats(_qc_records(pfa), kmer_len=kmer_len)
    js = jrs.compute_readstats(_qc_records(jfa), kmer_len=kmer_len)
    a, b = dataclasses.asdict(ps), dataclasses.asdict(js)
    for k in ("cycle_base", "cycle_qual", "gc_hist"):
        np.testing.assert_array_equal(a.pop(k), b.pop(k))
    assert a == b and ps.summary() == js.summary()
    assert ps.summary()["duplicate_reads"] >= 2
    prs.write_readstats_csv(tmp_path / "p", ps, kmer_len=kmer_len)
    jrs.write_readstats_csv(tmp_path / "j", js, kmer_len=kmer_len)
    for ext in ("cycles.csv", "quals.csv", "lens.csv", "kmers.csv",
                "summary.json"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes(), ext


@pytest.mark.parametrize("adapters,min_overlap,sub_rate", [
    (None, 5, 1), (None, 12, 0), (None, 5, 3),
    ({"x": "ACGTACGTACGTAGGA", "y": [0, 1, 2, 3, 3, 2, 1, 0]}, 4, 2)])
def test_contaminant_stats_match(tmp_path, adapters, min_overlap,
                                 sub_rate):
    kw = dict(min_overlap=min_overlap, sub_rate=sub_rate)
    ad = None if adapters is None else {
        k: (v if isinstance(v, str) else np.asarray(v, np.uint8))
        for k, v in adapters.items()}
    p = prs.compute_contaminant_stats(_qc_records(pfa), ad, **kw)
    j = jrs.compute_contaminant_stats(_qc_records(jfa), ad, **kw)
    assert p == j and p["reads"] == 253
    if adapters is None and sub_rate == 1:
        assert p["contaminated_reads"] >= 30
    prs.write_contaminant_csv(tmp_path / "p.csv", p)
    jrs.write_contaminant_csv(tmp_path / "j.csv", j)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    reads = np.stack([r.codes for r in _qc_records(pfa)[:51]])
    ph = prs.contaminant_hits(reads, ad, **kw)
    jh = jrs.contaminant_hits(reads, ad, **kw)
    assert ph.keys() == jh.keys()
    for k in ph:
        np.testing.assert_array_equal(ph[k].pop("_mask"), jh[k].pop("_mask"))
        assert ph[k] == jh[k]


def test_readstats_plots_render(tmp_path):
    """tests/test_tools.py::test_ngsqc_plot_rendering's reads: the same
    plots, each a PNG of more than 1,000 bytes."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    paths = {}
    for name, mod, fa in (("p", prs, pfa), ("j", jrs, jfa)):
        recs = [fa.SeqRecord(f"r{i}", "", rng.integers(0, 4, 100)
                             .astype(np.uint8), qual=rng.integers(
                                 20, 40, 100).astype(np.uint8))
                for i in range(50)]
        st = mod.compute_readstats(recs)
        paths[name] = mod.render_readstats_plots(str(tmp_path / name), st)
    assert [p.rsplit(".", 2)[-2:] for p in paths["p"]] == \
        [p.rsplit(".", 2)[-2:] for p in paths["j"]]
    assert len(paths["p"]) >= 3
    for p in paths["p"]:
        with open(p, "rb") as f:
            head = f.read()
        assert head.startswith(b"\x89PNG") and len(head) > 1000


def test_maploci_matches(tmp_path):
    """tests/test_bed.py::test_maploci's features and records, then the
    golden's control SAM against its BED."""
    feats = [("c1", 100, 300, "gA"), ("c1", 1000, 1200, "gB")]
    sp = tmp_path / "t.sam"
    with psam.SamWriter(sp, ["c1"], [5000]) as w:
        for name, flag, pos in (("r1", 0, 151), ("r2", 0, 1051),
                                ("r3", 0, 3001), ("r4", 4, 0)):
            w.write(psam.SamAlignment(name, flag, "c1" if pos else "*", pos,
                                      254, "100M" if pos else "*",
                                      seq="A" * 100))
    pb = pbed.BedFile([pbed.BedFeature(*f) for f in feats])
    jb = jbed.BedFile([jbed.BedFeature(*f) for f in feats])
    got = pbed.map_loci_to_features(pb, psam.read_sam(sp))
    assert got == jbed.map_loci_to_features(jb, jsam.read_sam(sp))
    assert got == ({"gA": 1, "gB": 1}, 1)
    w = mg.workload()
    (tmp_path / "f.bed").write_text(w["feats"])
    mg._sam(tmp_path / "c.sam", [("chrT", 30_000)], w["ctrl"])
    got = pbed.map_loci_to_features(pbed.BedFile.load(tmp_path / "f.bed"),
                                    psam.read_sam(tmp_path / "c.sam"))
    assert got == jbed.map_loci_to_features(
        jbed.BedFile.load(tmp_path / "f.bed"),
        jsam.read_sam(tmp_path / "c.sam"))
    assert any(":" in k for k in got[0]) and got[1] > 0


def _gene(mod, name="g1", chrom="c", start=0, end=1000, strand="+",
          cds=(100, 900), exons=((0, 400), (600, 1000))):
    return mod.GeneModel(chrom, start, end, name, strand, cds[0], cds[1],
                         np.asarray([a for a, _ in exons], np.int64),
                         np.asarray([b for _, b in exons], np.int64))


@pytest.mark.parametrize("region", range(7))
@pytest.mark.parametrize("strand", "+-")
def test_feature_spans_match(region, strand):
    for cds in ((100, 900), (0, 1000), (450, 450), (0, 50)):
        g = _gene(pbio, strand=strand, cds=cds,
                  exons=((0, 400), (600, 650), (700, 1000)))
        jg = _gene(jbio, strand=strand, cds=cds,
                   exons=((0, 400), (600, 650), (700, 1000)))
        assert pde._feature_spans(g, region) == \
            jde._feature_spans(jg, region)


def test_classify_lattice_matches():
    for fold in (-1.0, 0.0, 0.05, 0.1, 0.5, 0.8, 1.0, 1.25, 1.3, 1.5,
                 1.6, 1.75, 2.0, 30.0):
        for r in (-0.5, 0.0, 0.29, 0.3, 0.5, 0.79, 0.8, 1.0):
            for scored in (False, True):
                assert pde.classify(fold, r, scored) == \
                    jde.classify(fold, r, scored)
    assert pde.classify(1.0, 0.95, True) == (4, 4, 9)


@pytest.mark.parametrize("kw", [
    dict(num_bins=10, region=0, max_iters=500, norm_scale=1.0),
    dict(num_bins=5, region=1, norm_scale=0.0, coalesce_win=3,
         artifact_thres=4, max_iters=300),
    dict(num_bins=8, region=2, norm_scale=-2.0, min_feat_cnts=1,
         min_start_loci=1, feat_strand=1, filt_nonaligned=True,
         max_iters=200, seed=7)])
def test_rnade_process_matches(kw, tmp_path):
    """tests/test_rnade2.py's features and reads, its checks on the port's
    with that test's arguments, and every FeatDE field and both CSVs equal
    under each set of options."""
    rng = np.random.default_rng(2)
    peaks = np.clip(np.concatenate([
        rng.normal(50, 15, 300), rng.normal(450, 15, 200),
        rng.normal(850, 15, 100)]).astype(np.int64), 0, 940)

    def reads(chrom, positions, strand="+"):
        return [(chrom, int(p), int(p) + 50, strand) for p in positions]
    ctrl = reads("c", peaks) + reads("c2", rng.integers(0, 1000, 150))
    expr = reads("c", peaks + 3) + reads("c2", rng.integers(0, 1000, 600),
                                         "-")
    out = {}
    for name, mod, bio in (("p", pde, pbio), ("j", jde, jbio)):
        genes = [_gene(bio, "same", exons=((0, 1000),), cds=(0, 1000)),
                 _gene(bio, "up4x", chrom="c2", exons=((0, 1000),),
                       cds=(0, 1000)),
                 _gene(bio, "spliced", strand="-"),
                 _gene(bio, "empty", chrom="none")]
        out[name] = mod.rnade_process(ctrl, expr, genes, **kw)
        mod.write_rnade_csv(tmp_path / f"{name}.csv", out[name])
        mod.write_bin_counts_csv(tmp_path / f"{name}.bins", out[name])
    for a, b in zip(out["p"], out["j"]):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("ctrl_bins", "expr_bins"):
            np.testing.assert_array_equal(a.pop(k), b.pop(k))
        assert a == b
    assert len(out["p"]) == len(out["j"])
    for ext in ("csv", "bins"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    if kw["region"] == 0:
        by = {f.feature: f for f in out["p"]}
        assert by["same"].obs_pearson > 0.95 and by["same"].cnts_score == 4
        assert by["up4x"].fold_median > 1.75 and by["up4x"].cnts_score == 1


def test_rnade_read_loci_and_gene_bed_match(tmp_path):
    """load_read_loci from SAM (strand filters, limit), BED and loci CSV
    with exclusion zones; load_gene_bed on BED12 and BED6."""
    from kit4b_tpu.tools import convert as jconv
    from kit4b_tpu_torch.tools import convert as pconv
    w = mg.workload()
    mg.write_inputs(w, tmp_path, big=False)
    (tmp_path / "loci.bed").write_text(w["feats"])
    (tmp_path / "loci.csv").write_text(
        '"SrcID","Type","Species","Chrom","Start","End","Len","Strand"\n'
        '1,"e","s","chrT",100,199,100,"+"\n2,"e","s","chrT",13600,13700,'
        '101,"-"\n3,"e","s","chrT",500,600,101\nshort,row\n')
    zones = pconv.read_loci_csv(tmp_path / "zones.csv")
    assert zones == jconv.read_loci_csv(tmp_path / "zones.csv")
    assert pconv.read_loci_csv(tmp_path / "loci.csv") == \
        jconv.read_loci_csv(tmp_path / "loci.csv")
    for path in ("de_c.sam", "loci.bed", "loci.csv"):
        for kw in (dict(), dict(strand=1), dict(strand=2, limit=30),
                   dict(exclude_zones=zones)):
            assert pde.load_read_loci(tmp_path / path, **kw) == \
                jde.load_read_loci(tmp_path / path, **kw), (path, kw)
    assert pde.load_read_loci([tmp_path / "de_c.sam",
                               tmp_path / "de_e.sam"]) == \
        jde.load_read_loci([tmp_path / "de_c.sam", tmp_path / "de_e.sam"])
    pg = pbio.load_gene_bed(tmp_path / "genes.bed")
    jg = jbio.load_gene_bed(tmp_path / "genes.bed")
    assert len(pg) == len(jg) == 7
    for a, b in zip(pg, jg):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("exon_starts", "exon_ends"):
            np.testing.assert_array_equal(a.pop(k), b.pop(k))
        assert a == b


def test_revcomp_and_encode_used_by_the_scorers_match():
    """The codec calls the copied modules make on MAF and SAM text."""
    text = "ACGT-N-acgtn-" * 7
    np.testing.assert_array_equal(dna.encode(text), jdna.encode(text))
    c = dna.encode(text)
    np.testing.assert_array_equal(dna.revcomp(c), jdna.revcomp(c))
