"""The host modules the port keeps its own copies of, each held equal to its
original in the JAX package on the same seeded inputs: dna, io.fasta,
io.sam's flags and SEQ/QUAL helper, io.bed's reader, index (SfxIndex,
SA-IS), sim.simreads (every mode, SNP planting and its BED), align.snp,
tools.config4's genome,
utils.runtime, utils.summaries and the host functions of kmer.kmarkers
(pseudogenome, marker FASTA, the prekmarkers walk); and the port's own
build of the host library (native.py), keyed by its sources, flags and
CPU. Tests of the index skip when the library cannot be built."""
import gzip
import logging
import sqlite3
import subprocess

import numpy as np
import pytest

from kit4b_tpu import dna as jdna
from kit4b_tpu.align import snp as jsnp
from kit4b_tpu.index import sa_build as jsa
from kit4b_tpu.index import sfx_index as jsfx
from kit4b_tpu.io import fasta as jfa
from kit4b_tpu.io import sam as jsam
from kit4b_tpu.kmer import kmarkers as jkm
from kit4b_tpu.sim import simreads as jsim
from kit4b_tpu.utils import runtime as jrt
from kit4b_tpu.utils import summaries as jsum
from kit4b_tpu_torch import dna as pdna
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import snp as psnp
from kit4b_tpu_torch.index import sa_build as psa
from kit4b_tpu_torch.index import sfx_index as psfx
from kit4b_tpu_torch.io import fasta as pfa
from kit4b_tpu_torch.io import sam as psam
from kit4b_tpu_torch.kmer import kmarkers as pkm
from kit4b_tpu_torch.sim import simreads as psim
from kit4b_tpu_torch.utils import runtime as prt
from kit4b_tpu_torch.utils import summaries as psum


@pytest.fixture
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def _random_bases(rng, n, lower=0.1, n_rate=0.02):
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    s[rng.random(n) < n_rate] = ord("N")
    low = rng.random(n) < lower
    s[low] += 32                                 # lowercase a, c, g, t, n
    return s.tobytes()


def _genomes(seed):
    """(port Genome, JAX Genome) of the same seeded codes: three
    chromosomes with N runs and a repeat."""
    rng = np.random.default_rng(seed)
    recs = []
    for i, n in enumerate((3000, 1700, 900)):
        c = pdna.encode(_random_bases(rng, n, lower=0, n_rate=0.01))
        c[200:230] = 4
        if i == 1:
            c[500:800] = recs[0].codes[1000:1300]
        recs.append(pfa.SeqRecord(f"chr{i + 1}", "", c))
    pg = pfa.Genome.from_records(recs)
    jg = jfa.Genome(list(pg.names), pg.starts, pg.lengths, pg.seq)
    return pg, jg


def test_dna_tables_and_codecs_match():
    for name in ("BASE_A", "BASE_C", "BASE_G", "BASE_T", "BASE_N",
                 "BASE_UNDEF", "BASE_INDEL", "BASE_EOS", "BASE_EOG"):
        assert getattr(pdna, name) == getattr(jdna, name), name
    for table in ("_ASCII2CODE", "_CODE2ASCII", "_COMPLEMENT"):
        np.testing.assert_array_equal(getattr(pdna, table),
                                      getattr(jdna, table), err_msg=table)
    rng = np.random.default_rng(3)
    raw = _random_bases(rng, 1000, lower=0.3, n_rate=0.05) + b"-UuRx"
    codes = jdna.encode(raw)
    np.testing.assert_array_equal(pdna.encode(raw), codes)
    np.testing.assert_array_equal(pdna.encode(raw.decode()), codes)
    assert pdna.decode(codes) == jdna.decode(codes)
    np.testing.assert_array_equal(pdna.complement(codes),
                                  jdna.complement(codes))
    np.testing.assert_array_equal(pdna.revcomp(codes), jdna.revcomp(codes))
    for dt in (np.uint32, np.uint64):
        np.testing.assert_array_equal(pdna.pack2bit(codes[:997], dt),
                                      jdna.pack2bit(codes[:997], dt))
    assert pdna.kmer_codes_to_int(codes[:31] & 3) == \
        jdna.kmer_codes_to_int(codes[:31] & 3)


def test_sam_flags_match():
    for name in ("FLAG_PAIRED", "FLAG_PROPER_PAIR", "FLAG_UNMAPPED",
                 "FLAG_MATE_UNMAPPED", "FLAG_REVERSE", "FLAG_MATE_REVERSE",
                 "FLAG_FIRST", "FLAG_SECOND"):
        assert getattr(psam, name) == getattr(jsam, name), name
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, 37).astype(np.uint8)
    qual = rng.integers(0, 41, 37).astype(np.uint8)
    for q in (qual, None):
        for rev in (False, True):
            assert psam.seq_qual_for_strand(codes, q, rev) == \
                jsam.seq_qual_for_strand(codes, q, rev)


def test_bed_reader_matches(tmp_path):
    from kit4b_tpu.io import bed as jbed
    from kit4b_tpu_torch.io import bed as pbed
    path = tmp_path / "f.bed"
    path.write_text("track name=x\n# a comment\nbrowser position c1\n\n"
                    "c1\t10\t200\tg1\t5\t-\nc2 0 50\nc1\t300\t400\tg2\t.\n"
                    "c3\t7\t9\tg3\t2.5\t+\textra\n")
    got = pbed.BedFile.load(path)
    want = jbed.BedFile.load(path)
    assert len(got) == len(want) == 4
    assert [vars(f) for f in got.features] == \
        [vars(f) for f in want.features]


def test_format_sam_pe_binding_on_a_fixed_input(lib):
    """Three records (a proper pair and an unmapped mate) through the
    port's binding of format_sam_pe, against the JAX package's library
    and the text they must make."""
    import ctypes
    jlib = jsa._load_native()
    i32, i64 = np.int32, np.int64
    qn = [b"r1", b"r1", b"r2"]
    qn_ofs = np.array([0, 2, 4, 6], i64)
    chrom_cat, chrom_ofs = b"chrAchrB", np.array([0, 4, 8], i64)
    arrays = [np.array(a, t) for a, t in (
        ([99, 147, 77], i32), ([0, 0, -1], i32), ([11, 201, 0], i64),
        ([254, 254, 254], i32), ([-1, -1, -2], i32), ([201, 11, 0], i64),
        ([290, -290, 0], i64), ([2, 0, -1], i32))]
    seq = np.frombuffer(b"ACGTNACGTN" * 3, np.uint8).copy()
    qual = np.zeros(30, np.uint8)
    qual[10:20] = ord("I")     # phred+33 bytes, as the writers pass them
    outs = []
    for lib_ in (lib, jlib):
        cap = 1024
        buf = ctypes.create_string_buffer(cap)
        ptrs = [a.ctypes.data_as(ctypes.POINTER(
            ctypes.c_int32 if a.dtype == i32 else ctypes.c_int64))
            for a in arrays]
        u8 = ctypes.POINTER(ctypes.c_uint8)
        nb = lib_.format_sam_pe(
            b"".join(qn), qn_ofs.ctypes.data_as(ctypes.POINTER(
                ctypes.c_int64)), chrom_cat,
            chrom_ofs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), *ptrs,
            seq.ctypes.data_as(u8), qual.ctypes.data_as(u8), 3, 10, buf, cap)
        outs.append(buf.raw[:nb])
    assert outs[0] == outs[1]
    assert outs[0].decode().splitlines() == [
        "r1\t99\tchrA\t11\t254\t10M\t=\t201\t290\tACGTNACGTN\t*\t"
        "NM:i:2",
        "r1\t147\tchrA\t201\t254\t10M\t=\t11\t-290\tACGTNACGTN\t"
        "IIIIIIIIII\tNM:i:0",
        "r2\t77\t*\t0\t0\t*\t*\t0\t0\tACGTNACGTN\t*"]
    assert native.SIGNATURES["format_sam_pe"][0] is ctypes.c_int64


def _write_reads(path, rng, fmt, n=40, L=None, gz=False):
    """A FASTA or FASTQ of n seeded records with N and lowercase bases,
    uniform length L or mixed lengths."""
    lines = []
    for i in range(n):
        s = _random_bases(rng, L or int(rng.integers(20, 90))).decode()
        if fmt == "fasta":
            lines += [f">r{i} descr {i}", s[:30], s[30:]]
        else:
            q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(s)))
            lines += [f"@r{i} descr {i}", s, "+", q]
    data = ("\n".join(lines) + "\n").encode()
    (gzip.open if gz else open)(path, "wb").write(data)


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.name, a.descr) == (b.name, b.descr)
        np.testing.assert_array_equal(a.codes, b.codes)
        assert (a.qual is None) == (b.qual is None)
        if a.qual is not None:
            np.testing.assert_array_equal(a.qual, b.qual)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("gz", [False, True])
def test_fasta_readers_match(tmp_path, fmt, gz):
    rng = np.random.default_rng(17)
    path = tmp_path / (f"reads.{fmt}" + (".gz" if gz else ""))
    _write_reads(path, rng, fmt, gz=gz)
    _assert_records_equal(list(pfa.read_seqs(path)),
                          list(jfa.read_seqs(path)))
    pg, jg = pfa.Genome.load(path, path), jfa.Genome.load(path, path)
    assert pg.names == jg.names
    for key in ("starts", "lengths", "seq"):
        np.testing.assert_array_equal(getattr(pg, key), getattr(jg, key))
    assert pg.total_len == jg.total_len and pg.nchroms() == jg.nchroms()
    np.testing.assert_array_equal(pg.chrom_codes(1), jg.chrom_codes(1))
    pos = np.arange(0, len(pg.seq), 97)
    for a, b in zip(pg.locate(pos), jg.locate(pos)):
        np.testing.assert_array_equal(a, b)
    # uniform lengths: the bulk block reader
    upath = tmp_path / (f"uniform.{fmt}" + (".gz" if gz else ""))
    _write_reads(upath, rng, fmt, n=70, L=64, gz=gz)
    got = list(pfa.read_seq_blocks(upath, batch=32))
    want = list(jfa.read_seq_blocks(upath, batch=32))
    assert len(got) == len(want) == 3
    for (pn, pc, pq), (jn, jc, jq) in zip(got, want):
        assert pn == jn
        np.testing.assert_array_equal(pc, jc)
        assert (pq is None) == (jq is None)
        if pq is not None:
            np.testing.assert_array_equal(pq, jq)
    with pytest.raises(ValueError, match="non-uniform"):
        next(pfa.read_seq_blocks(path))


@pytest.mark.parametrize("suffix", [".fa", ".fa.gz", ".fq", ".fq.gz"])
def test_fasta_writers_match(tmp_path, suffix):
    rng = np.random.default_rng(23)
    recs = [pfa.SeqRecord(f"s{i}", "d" * i,
                          pdna.encode(_random_bases(rng, 50 + 37 * i)),
                          rng.integers(0, 41, 50 + 37 * i).astype(np.uint8)
                          if i % 2 else None)
            for i in range(5)]
    write_p = pfa.write_fastq if ".fq" in suffix else pfa.write_fasta
    write_j = jfa.write_fastq if ".fq" in suffix else jfa.write_fasta
    p, j = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    write_p(p, recs)
    write_j(j, recs)
    op = gzip.open if suffix.endswith(".gz") else open
    assert op(p, "rb").read() == op(j, "rb").read()


def test_suffix_array_matches(lib):
    rng = np.random.default_rng(5)
    for n in (1, 2, 50, 4000):
        text = rng.integers(0, 5, n).astype(np.uint8)
        text[-1] = jdna.BASE_EOG
        sa = psa.build_suffix_array(text)
        assert sa.dtype == np.int32
        np.testing.assert_array_equal(sa, jsa.build_suffix_array(text))


@pytest.mark.parametrize("lut_k", [None, 8, 11])
def test_sfx_index_build_matches(lib, lut_k):
    pg, jg = _genomes(7)
    p, j = psfx.SfxIndex.build(pg, lut_k), jsfx.SfxIndex.build(jg, lut_k)
    assert p.lut_k == j.lut_k
    for key in ("sa_clean", "lut"):
        a, b = getattr(p, key), getattr(j, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert psfx.pick_lut_k(len(pg.seq)) == jsfx.pick_lut_k(len(pg.seq))


@pytest.mark.parametrize("lut_k", [8, 12])
def test_bucket_index_matches(lib, lut_k):
    pg, jg = _genomes(9)
    p = psfx.SfxIndex.build_buckets(pg, lut_k)
    j = jsfx.SfxIndex.build_buckets(jg, lut_k)
    np.testing.assert_array_equal(p.sa_clean, j.sa_clean)
    np.testing.assert_array_equal(p.lut, j.lut)
    with pytest.raises(ValueError, match="lut_k <= 15"):
        psfx.SfxIndex.build_buckets(pg, 16)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kix_loads_in_either_package(lib, tmp_path, writer):
    pg, jg = _genomes(11)
    idx = (psfx.SfxIndex.build(pg) if writer == "port"
           else jsfx.SfxIndex.build(jg))
    path = tmp_path / "g.kix"
    idx.save(path)
    for loaded in (psfx.SfxIndex.load(path), jsfx.SfxIndex.load(path)):
        assert loaded.lut_k == idx.lut_k
        assert list(loaded.genome.names) == list(pg.names)
        for key in ("starts", "lengths", "seq"):
            np.testing.assert_array_equal(getattr(loaded.genome, key),
                                          getattr(pg, key))
        np.testing.assert_array_equal(loaded.sa_clean, idx.sa_clean)
        np.testing.assert_array_equal(loaded.lut, idx.lut)


@pytest.mark.parametrize("kw", [
    dict(error_mode="illumina", subs_rate=0.02),
    dict(error_mode="illumina", subs_rate=0.08, read_len=100),
    dict(error_mode="uniform", subs_rate=0.05),
    dict(error_mode="uniform", subs_rate=0.01, read_len=100),
    dict(error_mode="none"),
])
def test_sim_reads_match(kw):
    pg, jg = _genomes(13)
    params = dict(n_reads=300, read_len=60, seed=29) | kw
    got = psim.sim_reads(pg, psim.SimParams(**params))
    want = jsim.sim_reads(jg, jsim.SimParams(**params))
    _assert_records_equal(got, want)
    assert {rec.name.split("|")[6] for rec in got} == {"+", "-"}
    for rec in got[:20]:
        assert psim.parse_truth(rec.name) == jsim.parse_truth(rec.name)


SIM_MODES = [
    dict(pe=True, pe_insert_min=150, pe_insert_max=400,
         error_mode="illumina", subs_rate=0.02),
    dict(pe=True, read_len=50, error_mode="static", uniform_profile=True),
    dict(error_mode="fixed", subs_rate=3, strand="watson"),
    dict(pe=True, error_mode="uniform", indel_rate=0.3, indel_size=4),
    dict(error_mode="illumina", artef5_rate=0.2, artef3_rate=0.2,
         artef5_seqs=("ACGTACGTAC", "GGGCCC"), rand_reads=0.1),
    dict(pe=True, pe_insert_min=100, pe_insert_max=200, rand_reads=0.2,
         indel_rate=0.1, artef3_rate=0.1, error_mode="fixed", subs_rate=2),
    dict(regions=[("chr1", 100, 1500), ("chr2", 0, 1700),
                  ("nochr", 0, 900)], error_mode="uniform"),
    dict(pe=True, pe_insert_min=120, pe_insert_max=300,
         regions=[("chr3", 0, 900)]),
    dict(dedupe=True, read_len=12, n_reads=3000),
    dict(dedupe=True, pe=True, read_len=14, pe_insert_min=20,
         pe_insert_max=40, n_reads=2000),
]


@pytest.mark.parametrize("kw", SIM_MODES)
def test_sim_reads_every_mode_matches(kw):
    """Paired ends, the error modes, InDels, artefacts, random (lcr)
    reads, regions and dedupe draw the JAX package's stream."""
    pg, jg = _genomes(17)
    params = dict(n_reads=400, read_len=60, seed=41) | kw
    got = psim.sim_reads(pg, psim.SimParams(**params))
    want = jsim.sim_reads(jg, jsim.SimParams(**params))
    if kw.get("pe"):
        assert isinstance(got, tuple) and len(got) == 2
        for g_, w_ in zip(got, want):
            _assert_records_equal(g_, w_)
        got = got[0]
    else:
        _assert_records_equal(got, want)
    assert len(got) > 100
    tags = {r.name.split("|")[0] for r in got}
    assert tags == ({"lcl", "lcr"} if kw.get("rand_reads") else {"lcl"})
    if kw.get("indel_rate"):
        assert any(r.name.split("|")[8] != "0" for r in got)


def test_simulate_snps_and_their_bed_match(tmp_path):
    pg, jg = _genomes(5)
    g2, truth = psim.simulate_snps(pg, rate=0.01, seed=3)
    jg2, jtruth = jsim.simulate_snps(jg, rate=0.01, seed=3)
    assert truth == jtruth and len(truth) > 30
    np.testing.assert_array_equal(g2.seq, jg2.seq)
    assert (g2.names, g2.starts.tolist(), g2.lengths.tolist()) == \
        (jg2.names, jg2.starts.tolist(), jg2.lengths.tolist())
    psim.write_snp_bed(tmp_path / "p.bed", truth)
    jsim.write_snp_bed(tmp_path / "j.bed", jtruth)
    assert (tmp_path / "p.bed").read_bytes() == \
        (tmp_path / "j.bed").read_bytes()


def test_config4_genome_matches_the_tools_script():
    import importlib.util
    from pathlib import Path

    from kit4b_tpu_torch.tools.config4 import make_chr21_like
    path = Path(__file__).resolve().parents[1] / "tools" / "config4_chr21.py"
    spec = importlib.util.spec_from_file_location("_config4_chr21", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seq, n = make_chr21_like(0.5)
    want, wn = mod.make_chr21_like(0.5)
    assert n == wn == 500_000
    np.testing.assert_array_equal(seq, want)
    assert (seq == pdna.BASE_N).sum() > 5000


def test_write_reads_match(tmp_path):
    pg, _ = _genomes(19)
    recs = psim.sim_reads(pg, psim.SimParams(n_reads=50, read_len=40,
                                             seed=2, error_mode="uniform"))
    for fmt in ("fasta", "fastq"):
        psim.write_reads(tmp_path / f"p.{fmt}", recs, fmt)
        jsim.write_reads(tmp_path / f"j.{fmt}", recs, fmt)
        assert (tmp_path / f"p.{fmt}").read_bytes() == \
            (tmp_path / f"j.{fmt}").read_bytes()


@pytest.mark.parametrize("min_reads", [3, 5])
def test_snp_calls_match_on_one_pileup(tmp_path, min_reads):
    pg, jg = _genomes(31)
    rng = np.random.default_rng(min_reads)
    L, N = 50, 4000
    pos = rng.integers(0, len(pg.seq) - L, N)
    reads = pg.seq[pos[:, None] + np.arange(L)].copy()
    reads = np.where(reads < 4, reads, 0).astype(np.uint8)
    for locus in rng.integers(0, len(pg.seq) - L, 12):     # planted SNPs
        hit = (pos <= locus) & (locus < pos + L)
        alt = (pg.seq[locus] + 1) % 4 if pg.seq[locus] < 4 else 0
        reads[hit, locus - pos[hit]] = alt
    noise = rng.random(reads.shape) < 0.01
    reads[noise] = rng.integers(0, 5, int(noise.sum()))
    opts = dict(min_snp_reads=min_reads, qvalue=0.05)
    pc = psnp.SnpCaller(pg, psnp.SnpOptions(**opts))
    jc = jsnp.SnpCaller(jg, jsnp.SnpOptions(**opts))
    for b in range(0, N, 1000):
        pc.add_alignments(pos[b:b + 1000], reads[b:b + 1000])
        jc.add_alignments(pos[b:b + 1000], reads[b:b + 1000])
    np.testing.assert_array_equal(pc.coverage(), jc.coverage())
    got, want = pc.call(), jc.call()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for f in ("chrom", "loci", "ref_base", "tot_bases", "non_ref",
                  "bkgd_rate", "pvalue", "rank"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_array_equal(a.counts, b.counts)
    assert psnp.ref_binomial_cdf(6000, 40, 0.01) == \
        jsnp.ref_binomial_cdf(6000, 40, 0.01)
    for ext, pw, jw in (("csv", psnp.write_snps_csv, jsnp.write_snps_csv),
                        ("vcf", psnp.write_snps_vcf, jsnp.write_snps_vcf)):
        pw(tmp_path / f"p.{ext}", got)
        jw(tmp_path / f"j.{ext}", want)
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append((record.msg, record.args[0]))


def test_phase_timer_matches():
    assert prt.log.name == "kit4b_tpu_torch"
    got = {}
    for mod in (prt, jrt):
        h = _Records()
        mod.log.addHandler(h)
        level = mod.log.level
        mod.log.setLevel(logging.INFO)
        try:
            t = mod.PhaseTimer()
            for name in ("load", "sweep", "load"):
                with t.phase(name):
                    pass
            with pytest.raises(KeyError):
                with t.phase("fails"):
                    raise KeyError("x")
        finally:
            mod.log.removeHandler(h)
            mod.log.setLevel(level)
        assert t.total() >= sum(t.phases.values()) >= 0
        got[mod] = (list(t.phases), h.messages)
    assert got[prt] == got[jrt]
    assert got[prt][0] == ["load", "sweep", "fails"]


def _db_rows(path):
    with sqlite3.connect(path) as db:
        return {
            "exprs": db.execute("SELECT ExprName, ExprDescr FROM TblExprs "
                                "ORDER BY ExprID").fetchall(),
            "process": db.execute("SELECT ProcessName, Version FROM "
                                  "TblProcess ORDER BY ProcessID").fetchall(),
            "runs": db.execute("SELECT ExprID, ProcessID, ExitCode, "
                               "Finished >= Started FROM TblProcessing ORDER "
                               "BY ProcessingID").fetchall(),
            "params": db.execute("SELECT * FROM TblParams").fetchall(),
            "results": db.execute("SELECT * FROM TblResults").fetchall(),
            "log": db.execute("SELECT ProcessingID, LogText FROM "
                              "TblProcessingLog").fetchall(),
        }


def test_summaries_round_trip_matches(tmp_path):
    assert psum.SCHEMA == jsum.SCHEMA
    rows = {}
    for name, mod in (("port", psum), ("jax", jsum)):
        path = tmp_path / f"{name}.db"
        for run, rc in ((1, 0), (2, 3)):
            s = mod.Summaries(path, "exp", "a test", process=f"p{run % 2}",
                              version="0.1")
            s.params(K=25, infile="g.fa")
            s.results(wall_seconds=1.5, run=run)
            s.log(f"run {run}")
            s.finish(rc)
        rows[name] = _db_rows(path)
    assert rows["port"] == rows["jax"]
    assert rows["port"]["runs"] == [(1, 1, 0, 1), (1, 2, 3, 1)]


def test_host_library_flags_are_the_makefiles():
    make = (native.PKG.parent / "native" / "Makefile").read_text()
    line = next(ln for ln in make.splitlines() if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("?=", 1)[1].split()) == native.CXXFLAGS


def test_host_library_builds_into_the_port(monkeypatch, tmp_path):
    if native.shutil.which("g++") is None:
        pytest.skip("no g++")
    src_dir = native.SOURCES[0].parent
    before = sorted((p.name, p.stat().st_mtime_ns) for p in src_dir.iterdir())
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    path = native.build()
    assert path.parent == tmp_path / "_build" and path.exists()
    assert path.name.startswith("libkit4b_native-")
    assert native.build() == path                   # built once per key
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in src_dir.iterdir()) == before
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         capture_output=True, text=True)
    if out.returncode == 0:
        for name in native.SIGNATURES:
            assert f" {name}" in out.stdout, name


def test_host_library_key_follows_sources_and_flags(monkeypatch):
    key = native.lib_path()
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-g",))
    assert native.lib_path() != key


def test_host_library_key_follows_the_cpu(monkeypatch):
    """A `_build/` carried to a host whose `-march=native` means another
    CPU builds anew instead of loading the other host's library."""
    monkeypatch.setattr(native, "cpu_identity", lambda: "-march= skylake")
    skylake = native.lib_path()
    assert native.lib_path() == skylake
    monkeypatch.setattr(native, "cpu_identity",
                        lambda: "-march= sapphirerapids")
    assert native.lib_path() != skylake
    monkeypatch.setattr(native, "cpu_identity",
                        lambda: "flags\t: fpu sse2 avx2")
    other = native.lib_path()
    assert other != skylake and other.parent == skylake.parent


def test_cpu_identity_is_what_march_native_resolves_to():
    ident = native.cpu_identity()
    assert ident and native.cpu_identity() is ident      # probed once
    if native.shutil.which("g++"):
        assert "-march=" in ident
    else:
        assert ident.startswith("flags")


def test_host_library_without_compiler_or_source_raises(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(native.NativeUnavailable, match="g\\+\\+ not found"):
        native.build()
    monkeypatch.setattr(native, "SOURCES", (tmp_path / "missing.cpp",))
    with pytest.raises(native.NativeUnavailable, match="source missing"):
        native.build()
    assert not (tmp_path / "_build").exists()


def _cultivar_fastas(tmp_path, seed):
    """Three cultivars in FASTA files, one of two chromosomes, sharing
    sequence, with N runs and lowercase bases."""
    rng = np.random.default_rng(seed)
    base = _random_bases(rng, 1500, lower=0.2, n_rate=0.01)
    specs = {}
    for c in range(3):
        s = bytearray(base)
        for p in rng.integers(0, 1500, 30):
            s[p] = b"ACGT"[int(rng.integers(0, 4))]
        paths = [tmp_path / f"c{c}.fa"]
        recs = [(f"chr{c}", bytes(s))]
        if c == 2:
            paths.append(tmp_path / "c2b.fa")
            recs.append(("chr2b", _random_bases(rng, 700)))
        for path, (name, seq) in zip(paths, recs):
            path.write_bytes(b">" + name.encode() + b"\n" + seq + b"\n")
        specs[f"cult{c}"] = paths
    return specs


def _kmarkers_inputs(tmp_path, seed):
    """(port (genome, index, chrom_cult, names), JAX the same) of the
    cultivars' pseudo-genome, each through its own package."""
    specs = _cultivar_fastas(tmp_path, seed)
    pg, pcc, pnames = pkm.build_pseudogenome(specs)
    jg, jcc, jnames = jkm.build_pseudogenome(specs)
    return ((pg, psfx.SfxIndex.build(pg), pcc, pnames),
            (jg, jsfx.SfxIndex.build(jg), jcc, jnames))


def test_pseudogenome_and_bed_match(tmp_path):
    specs = _cultivar_fastas(tmp_path, 41)
    (pg, pcc, pn), (jg, jcc, jn) = (pkm.build_pseudogenome(specs),
                                    jkm.build_pseudogenome(specs))
    assert pn == jn == ["cult0", "cult1", "cult2"]
    assert pg.names == jg.names and pg.names[-1] == "cult2.chr2b"
    for key in ("starts", "lengths", "seq"):
        np.testing.assert_array_equal(getattr(pg, key), getattr(jg, key))
    np.testing.assert_array_equal(pcc, jcc)
    assert pcc.dtype == jcc.dtype == np.int32
    pkm.write_pseudogenome_bed(tmp_path / "p.bed", pg, pcc, pn)
    jkm.write_pseudogenome_bed(tmp_path / "j.bed", jg, jcc, jn)
    assert (tmp_path / "p.bed").read_bytes() == \
        (tmp_path / "j.bed").read_bytes()


def test_write_markers_fasta_matches(tmp_path):
    rng = np.random.default_rng(43)
    seqs = [rng.integers(0, 5, n).astype(np.uint8) for n in (50, 131, 71)]
    pm = [pkm.Marker(f"c.chr{i}", 10 * i, len(s), s)
          for i, s in enumerate(seqs)]
    jm = [jkm.Marker(m.chrom, m.start, m.length, m.seq) for m in pm]
    for prefix in ("Marker", "M"):
        pkm.write_markers_fasta(tmp_path / "p.fa", pm, prefix)
        jkm.write_markers_fasta(tmp_path / "j.fa", jm, prefix)
        assert (tmp_path / "p.fa").read_bytes() == \
            (tmp_path / "j.fa").read_bytes()


@pytest.mark.parametrize("kmer_len,block", [(9, 1 << 18), (20, 1000)])
def test_prefix_kmer_counts_and_antisense_match(lib, tmp_path, kmer_len,
                                                block):
    (pg, pi, pcc, pn), (jg, ji, jcc, jn) = _kmarkers_inputs(tmp_path, 47)
    pr, pc = pkm.prefix_kmer_counts(pi, pcc, 3, kmer_len=kmer_len,
                                    block=block)
    jr, jc = jkm.prefix_kmer_counts(ji, jcc, 3, kmer_len=kmer_len,
                                    block=block)
    for a, b in ((pr, jr), (pc, jc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (pc.sum(1) > 1).any()
    np.testing.assert_array_equal(
        pkm.antisense_counts(pi, pr, pc, kmer_len),
        jkm.antisense_counts(ji, jr, jc, kmer_len))
    with pytest.raises(ValueError, match="K <= 31"):
        pkm.antisense_counts(pi, pr, pc, 32)


@pytest.mark.parametrize("kw", [dict(kmer_len=12), dict(kmer_len=16,
                                min_cultivars=3, max_per_cultivar=1),
                                dict(kmer_len=10, antisense=False)])
def test_shared_prefix_markers_match(lib, tmp_path, kw):
    (_, pi, pcc, _), (_, ji, jcc, _) = _kmarkers_inputs(tmp_path, 53)
    got = pkm.shared_prefix_markers(pi, pcc, 3, **kw)
    want = jkm.shared_prefix_markers(ji, jcc, 3, **kw)
    assert len(got) == len(want) > 0
    for (pc, pn), (jc, jn) in zip(got, want):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pn, jn)


@pytest.mark.parametrize("kw", [dict(prefix_len=10, suffix_len=4),
                                dict(prefix_len=12, suffix_len=3,
                                     min_cultivars=3, max_homozygotic=2),
                                dict(prefix_len=9, suffix_len=5,
                                     max_homozygotic=0, antisense=False)])
def test_shared_prefix_suffix_markers_match(lib, tmp_path, kw):
    (_, pi, pcc, _), (_, ji, jcc, _) = _kmarkers_inputs(tmp_path, 59)
    got = pkm.shared_prefix_suffix_markers(pi, pcc, 3, **kw)
    want = jkm.shared_prefix_suffix_markers(ji, jcc, 3, **kw)
    assert len(got) == len(want) > 0
    for (pc, pn), (jc, jn) in zip(got, want):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pn, jn)
