"""The host modules the port keeps its own copies of, each held equal to its
original in the JAX package on the same seeded inputs: dna, io.fasta,
io.sam's flags, writer, reader and SEQ/QUAL helper, io.bed's reader and
overlap queries, io.bam, io.wig, kmer.pba, align.phases, the rescue
finders ops.indel, ops.splice and ops.chimeric, index (SfxIndex,
SA-IS), sim.simreads (every mode, SNP planting and its BED), align.snp,
tools.config4's genome,
utils.runtime, utils.summaries and the host functions of kmer.kmarkers
(pseudogenome, marker FASTA, the prekmarkers walk), the PacBio host code
(pacbio.consensus, align.blitz's `_seed_hits`, ecreads' read index and
candidates, pbfilter's `_self_rc_diag`, tools.pacbio_reads' CLR readset);
the long-tail host code (io.bed's `contains`, `write_bed` and
`map_loci_to_features`, io.biobed's gene BED reader, tools.convert's loci
CSV reader, rnade's numeric helpers, magicbench's profile refinement and
replay, blitz's PSL writer, readstats on empty inputs; the rest of those
modules in tests/test_torch_blitz.py, test_torch_longtail.py and
test_torch_scorers.py);
and the port's own build of the host library (native.py), keyed by its
sources, flags and CPU. Tests of the index skip when the library cannot be
built."""
import copy
import dataclasses
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


def test_sam_writer_matches(tmp_path):
    recs = [dict(qname="r1", flag=16, rname="c1", pos=7, mapq=244,
                 cigar="40M2D60M", seq="ACGT", qual="IIII",
                 tags=("NM:i:3",)),
            dict(qname="r2", flag=4, rname="*", pos=0, mapq=0, cigar="*"),
            dict(qname="r3", flag=99, rname="c2", pos=1, mapq=254,
                 cigar="5S95M", rnext="=", pnext=300, tlen=-400)]
    out = []
    for mod in (psam, jsam):
        path = tmp_path / f"{mod.__name__}.sam"
        with mod.SamWriter(path, ["c1", "c2"], [100, 2000],
                           pg_cl="kalign -y 20") as w:
            for r in recs:
                w.write(mod.SamAlignment(**r))
        out.append(path.read_bytes())
    assert out[0] == out[1]
    assert out[0].startswith(b"@HD\tVN:1.4\tSO:unsorted\n@SQ\tSN:c1")


def _rescue_inputs(kind):
    """A 30 kbp genome, reads of 100 bp oriented to it, and their
    candidate loci ([B, C], INT32_MAX padded): a one-InDel read per size
    and kind, a two-exon read on each planted intron, or a read with
    random flanks, each with its true locus among decoys; and a random
    read."""
    rng = np.random.default_rng({"indel": 1, "splice": 2, "chimeric": 3}
                                [kind])
    g = rng.integers(0, 4, 30_000).astype(np.uint8)
    g[rng.integers(0, 30_000, 20)] = 4
    reads, cands = [], []
    for i in range(12):
        p = 500 + i * 2_000
        if kind == "indel":
            d, s = 1 + i % 6, 20 + 5 * i
            r = np.concatenate([g[p:p + s], g[p + s + d:p + 100 + d]]) \
                if i % 2 else np.concatenate(
                    [g[p:p + s], rng.integers(0, 4, d), g[p + s:p + 100 - d]])
        elif kind == "splice":
            s, gap = 20 + 5 * i, 150 + 40 * i
            g[p + s:p + s + 2] = (2, 3)
            g[p + s + gap - 2:p + s + gap] = (0, 2)
            r = np.concatenate([g[p:p + s], g[p + s + gap:p + gap + 100]])
            cands.append([p + gap, p, 7_777, 2 ** 31 - 1])
        else:
            t5, keep = i * 2, 55 + 2 * i
            r = np.concatenate([rng.integers(0, 4, t5), g[p:p + keep],
                                rng.integers(0, 4, 100 - t5 - keep)])
            p -= t5
        reads.append(r.astype(np.uint8)[:100])
        if kind != "splice":
            cands.append([3_333, p, 2 ** 31 - 1, p + 5])
    reads.append(rng.integers(0, 4, 100).astype(np.uint8))
    cands.append([200, 9_000, 2 ** 31 - 1, 2 ** 31 - 1])
    pos = np.array(cands, np.int64)
    strand = np.zeros_like(pos)
    strand[::3] = 1
    return g, np.stack(reads), pos, strand


@pytest.mark.parametrize("kind,kw", [
    ("indel", {}), ("indel", dict(max_indel=4, max_mm=1, min_seg=12)),
    ("splice", {}), ("splice", dict(max_gap=400, min_gap=100)),
    ("chimeric", {}), ("chimeric", dict(min_chimeric_pct=70,
                                        subs_per_100=2))])
def test_rescue_finders_match(kind, kw):
    import importlib
    mods = [importlib.import_module(f"{pkg}.ops.{kind}")
            for pkg in ("kit4b_tpu_torch", "kit4b_tpu")]
    find = {"indel": "find_indels", "splice": "find_splices",
            "chimeric": "find_chimeric"}[kind]
    g, reads, pos, strand = _rescue_inputs(kind)
    got, want = (getattr(m, find)(g, reads, pos, strand, **kw)
                 for m in mods)
    assert [None if h is None else (vars(h), h.cigar(100)) for h in got] \
        == [None if h is None else (vars(h), h.cigar(100)) for h in want]
    assert got[-1] is None
    if not kw:
        assert sum(h is not None for h in got) >= 6


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


def test_bed_overlap_queries_match():
    """BedFile.overlapping: features sorted by start with the running
    maximum of their ends, queries touching each end exactly."""
    from kit4b_tpu.io import bed as jbed
    from kit4b_tpu_torch.io import bed as pbed
    rng = np.random.default_rng(8)
    feats = []
    for i in range(300):
        s0 = int(rng.integers(0, 20_000))
        feats.append((f"c{i % 3}", s0, s0 + int(rng.integers(1, 2_000)),
                      f"f{i}"))
    j = jbed.BedFile([jbed.BedFeature(*f) for f in feats])
    p = pbed.BedFile([pbed.BedFeature(*f) for f in feats])
    queries = [(c, a, a + int(rng.integers(1, 300)))
               for c, a in zip(rng.choice(["c0", "c1", "c2", "c9"], 500),
                               rng.integers(0, 22_000, 500))]
    queries += [(c, e, e + 5) for c, _, e, _ in feats[:50]]     # at an end
    queries += [(c, b - 5, b) for c, b, _, _ in feats[:50]]     # to a start
    n = 0
    for c, a, b in queries:
        got = [vars(f) for f in p.overlapping(str(c), int(a), int(b))]
        assert got == [vars(f) for f in j.overlapping(str(c), int(a),
                                                         int(b))]
        n += bool(got)
    assert n > 100


def test_bam_writer_and_reader_match(tmp_path):
    """io.bam's copy: a few records (reverse, soft clips, no quality,
    a mate, unmapped) with a CSI, read back by either package."""
    from kit4b_tpu.io import bam as jbam
    from kit4b_tpu_torch.io import bam as pbam
    recs = [dict(qname="a", flag=0, rname="c1", pos=5, mapq=254,
                 cigar="4S20M", seq="ACGTACGTACGTACGTACGTACGT",
                 qual="I" * 24, tags=("NM:i:1",)),
            dict(qname="b", flag=16, rname="c1", pos=900, mapq=30,
                 cigar="10M", rnext="=", pnext=950, tlen=60,
                 seq="NNACGTACGT", qual="*"),
            dict(qname="u", flag=4, rname="*", pos=0, mapq=0, cigar="*",
                 seq="ACGN", qual="*")]
    for tag, mod, sam in (("j", jbam, jsam), ("p", pbam, psam)):
        with mod.BamWriter(tmp_path / f"{tag}.bam", ["c1", "c2"],
                           [1000, 50], pg_cl="x", index="csi") as w:
            for r in recs:
                w.write(sam.SamAlignment(**r))
    for f in ("bam", "bam.csi"):
        assert (tmp_path / f"j.{f}").read_bytes() == \
            (tmp_path / f"p.{f}").read_bytes()
    assert [vars(a) for a in pbam.read_bam(tmp_path / "j.bam")] == \
        [vars(a) for a in jbam.read_bam(tmp_path / "p.bam")]


def test_sam_reader_matches(tmp_path):
    path = tmp_path / "x.sam"
    path.write_text("@HD\tVN:1.4\nr1\t16\tc1\t7\t254\t10M\t*\t0\t0\t"
                    "ACGTACGTAC\t*\tNM:i:2\tXF:f:1.5\tRG:Z:g\tbad\n"
                    "short\tline\nr2\t4\t*\t0\t0\t*\t*\t0\t0\tAC\t*\n")
    got = [vars(r) for r in psam.read_sam(path)]
    assert got == [vars(r) for r in jsam.read_sam(path)] and len(got) == 2
    assert [r.is_mapped for r in psam.read_sam(path)] == [True, False]


def test_wig_and_pba_writers_match(tmp_path):
    from kit4b_tpu.io.wig import write_wig as jwig
    from kit4b_tpu.kmer import pba as jpba
    from kit4b_tpu_torch.io.wig import write_wig as pwig
    from kit4b_tpu_torch.kmer import pba as ppba
    pg, jg = _genomes(12)
    rng = np.random.default_rng(12)
    cov = (rng.integers(0, 4, len(pg.seq)) * (rng.random(len(pg.seq)) < 0.3)
           ).astype(np.uint32)
    cov[pg.starts[2]:] = 0          # a chromosome with no coverage
    jwig(tmp_path / "j.wig", jg, cov, track_name="t")
    pwig(tmp_path / "p.wig", pg, cov, track_name="t")
    assert (tmp_path / "j.wig").read_bytes() == \
        (tmp_path / "p.wig").read_bytes()
    counts = rng.integers(0, 7, (len(pg.seq), 5)).astype(np.uint32)
    got = ppba.pba_from_counts(counts)
    np.testing.assert_array_equal(got, jpba.pba_from_counts(counts))
    ppba.save_pba(tmp_path / "p.pba.npz", pg, got, readset="rs")
    rs, chroms = jpba.load_pba(tmp_path / "p.pba.npz")
    rs2, chroms2 = ppba.load_pba(tmp_path / "p.pba.npz")
    assert rs == rs2 == "rs" and list(chroms) == list(chroms2) == pg.names
    for k in chroms:
        np.testing.assert_array_equal(chroms[k], chroms2[k])


@pytest.mark.parametrize("phase", ["auto_trim_flanks", "pcr5_primer_correct",
                                   "constraints", "assign_multi_random",
                                   "expand_multi_all", "assign_multi_matches",
                                   "side_files"])
def test_phases_match(tmp_path, phase):
    """align.phases' copy on one synthetic (rec, res) list: accepted reads
    with mismatches at the flanks and the 5' end, on both strands, and
    multi reads whose loci share unique reads' coverage."""
    from kit4b_tpu.align import kalign as jk
    from kit4b_tpu.align import phases as jph
    from kit4b_tpu_torch.align import kalign as pk
    from kit4b_tpu_torch.align import phases as pph
    pg, jg = _genomes(13)
    rng = np.random.default_rng(13)
    L = 60
    base = []
    for i in range(120):
        strand = i % 2
        pos = int(rng.integers(0, 2_900))
        if i % 7 == 0:
            pos = 1000 + int(rng.integers(0, 30))   # the repeat's first copy
        codes = pg.seq[pos:pos + L].copy()
        mm = rng.choice(L, int(rng.integers(0, 5)), replace=False)
        for m in mm:
            codes[m] = (codes[m] + 1) % 4
        if i % 5 == 0:
            codes[:3] = (codes[:3] + 1) % 4
        if strand:
            codes = pdna.revcomp(codes)
        o = int(rng.integers(0, 200))
        if i % 11 == 0:
            res = ("multi", dict(mm=1, n_low=2, multi_ids=np.array(
                [(1000 + o) * 2, (3500 + o) * 2 + 1, 2 ** 31 - 1],
                np.int64)))
        elif i % 13 == 0:
            res = ("nohit", {})
        else:
            res = ("accepted", dict(
                strand=strand, pos=pos, n_low=1,
                mm=int(((codes if not strand else pdna.revcomp(codes))
                        != pg.seq[pos:pos + L]).sum())))
        base.append((f"r{i}", codes, res))

    def stream(mod_fa, mod_k):
        return [(mod_fa.SeqRecord(n, "d", c.copy()),
                 mod_k.AlignResult(nar, **copy.deepcopy(kw)))
                for n, c, (nar, kw) in base]
    j, p = stream(jfa, jk), stream(pfa, pk)
    args = {"auto_trim_flanks": (jg.seq, 8), "pcr5_primer_correct":
            (jg.seq, 1, 12)}
    if phase == "constraints":
        (tmp_path / "c.csv").write_text(
            "# c\nchr1,1005,\"AC\"\nchr1,2000,G\nchr9,1,A\nchr2,10,T\n")
        cj = jph.load_loci_constraints(tmp_path / "c.csv", jg)
        cp = pph.load_loci_constraints(tmp_path / "c.csv", pg)
        assert cj == cp
        out = (jph.identify_constraint_violations(j, cj),
               pph.identify_constraint_violations(p, cp))
    elif phase == "side_files":
        out = (jph.report_none_aligned(tmp_path / "j.fa", j),
               pph.report_none_aligned(tmp_path / "p.fa", p),
               jph.report_multi_align(tmp_path / "jm.fa", j),
               pph.report_multi_align(tmp_path / "pm.fa", p))
        assert (tmp_path / "j.fa").read_bytes() == \
            (tmp_path / "p.fa").read_bytes()
        assert (tmp_path / "jm.fa").read_bytes() == \
            (tmp_path / "pm.fa").read_bytes()
    elif phase == "expand_multi_all":
        j, p = jph.expand_multi_all(j), pph.expand_multi_all(p)
        out = (len(j), len(p))
    else:
        extra = args.get(phase, ())
        out = (getattr(jph, phase)(j, *extra),
               getattr(pph, phase)(p, *extra))
    assert out[0] == out[1]

    def fields(stream):
        return [(r.name, r.codes.tolist(), {
            k: v.tolist() if isinstance(v, np.ndarray) else v
            for k, v in vars(a).items()}) for r, a in stream]
    assert fields(p) == fields(j)


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


# --- config #5's host copies and the float commands' I/O -----------------

def _store_records(seed, pkg_rec, n=40, pe=False):
    """Seeded reads with qualities, Ns and ragged lengths as `pkg_rec`
    SeqRecords (mate-2 records too when pe)."""
    rng = np.random.default_rng(seed)
    out = []
    for m in range(2 if pe else 1):
        recs = []
        for i in range(n):
            L = int(rng.integers(20, 150))
            c = rng.integers(0, 4, L).astype(np.uint8)
            c[rng.random(L) < 0.01] = 4
            q = rng.integers(20, 41, L).astype(np.uint8)
            q[rng.random(L) < 0.01] = 3
            recs.append(pkg_rec(f"r{i}/{m}", "", c, q))
        out.append(recs)
    return out if pe else out[0]


@pytest.mark.parametrize("kw", [dict(), dict(min_phred=5, trim5=2, trim3=3),
                                dict(max_ns_pct=0, min_len=40)])
@pytest.mark.parametrize("pe", [False, True])
def test_seq_store_from_records_and_compact_match(kw, pe):
    from kit4b_tpu.assembly import store as jst
    from kit4b_tpu_torch.assembly import store as pst
    assert (pst.STORE_VERSION, pst.FLAG_DELETED, pst.FLAG_PE1, pst.FLAG_PE2,
            pst.FLAG_DUP, pst.FLAG_NOOVL, pst.FLAG_MERGED) == \
        (jst.STORE_VERSION, jst.FLAG_DELETED, jst.FLAG_PE1, jst.FLAG_PE2,
         jst.FLAG_DUP, jst.FLAG_NOOVL, jst.FLAG_MERGED)
    jr, pr = _store_records(7, jfa.SeqRecord, pe=pe), \
        _store_records(7, pfa.SeqRecord, pe=pe)
    j = jst.SeqStore.from_records(*(jr if pe else (jr,)), **kw)
    p = pst.SeqStore.from_records(*(pr if pe else (pr,)), **kw)
    for s in (j, p):
        s.flags[::5] |= jst.FLAG_DELETED
    for got, want in ((p, j), (p.compact(), j.compact())):
        for k in ("seq", "starts", "lengths", "flags"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert (got.mate is None) == (want.mate is None)
        if want.mate is not None:
            np.testing.assert_array_equal(got.mate, want.mate)
        assert got.n_live() == want.n_live() > 0
        assert [(r.name, r.codes.tolist()) for r in
                got.to_fasta_records("x")] == \
            [(r.name, r.codes.tolist()) for r in want.to_fasta_records("x")]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("pe", [False, True])
def test_seq_store_checkpoint_loads_in_either_package(tmp_path, writer, pe):
    from kit4b_tpu.assembly import store as jst
    from kit4b_tpu_torch.assembly import store as pst
    pkg, rec = (pst, pfa.SeqRecord) if writer == "port" \
        else (jst, jfa.SeqRecord)
    recs = _store_records(9, rec, pe=pe)
    st = pkg.SeqStore.from_records(*(recs if pe else (recs,)))
    st.flags[3] |= pkg.FLAG_DUP | pkg.FLAG_DELETED
    st.save(tmp_path / "ck")                      # written as ck.npz
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    for loaded in (pst.SeqStore.load(tmp_path / "ck"),
                   jst.SeqStore.load(tmp_path / "ck.npz")):
        for k in ("seq", "starts", "lengths", "flags"):
            np.testing.assert_array_equal(getattr(loaded, k), getattr(st, k))
        np.testing.assert_array_equal(loaded.mate, st.mate)
    np.savez_compressed(tmp_path / "v2.npz", version=np.int64(2),
                        seq=st.seq, starts=st.starts, lengths=st.lengths,
                        flags=st.flags, mate=np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="unsupported store version 2"):
        pst.SeqStore.load(tmp_path / "v2.npz")


def test_adapter_table_and_corpus_genome_match():
    from kit4b_tpu.assembly import contaminants as jco
    from kit4b_tpu.assembly import overlap as jov
    from kit4b_tpu.assembly import store as jst
    from kit4b_tpu_torch.assembly import contaminants as pco
    from kit4b_tpu_torch.assembly import overlap as pov
    from kit4b_tpu_torch.assembly import store as pst
    assert pco.DEFAULT_ADAPTERS == jco.DEFAULT_ADAPTERS
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 5, int(n)).astype(np.uint8)
              for n in rng.integers(5, 60, 30)]
    j, p = jst.SeqStore.from_arrays(arrays), pst.SeqStore.from_arrays(arrays)
    for s in (j, p):
        s.flags[[2, 7]] |= jst.FLAG_DELETED
    for rc in (True, False):
        (jg, jl), (pg, pl) = jov.corpus_genome(j, rc), pov.corpus_genome(p, rc)
        np.testing.assert_array_equal(pl, jl)
        assert pg.names == jg.names
        for k in ("starts", "lengths", "seq"):
            np.testing.assert_array_equal(getattr(pg, k), getattr(jg, k))


def test_scaffold_host_functions_match(tmp_path):
    """collect_links over SAM records, build_scaffolds (votes, gaps, ends
    used once, cycles refused) and write_scaffolds, through pescaffold."""
    from kit4b_tpu.assembly import scaffold as jsc
    from kit4b_tpu_torch.assembly import scaffold as psc
    rng = np.random.default_rng(5)
    ctgs = {f"c{i}": rng.integers(0, 4, int(rng.integers(50, 400)))
            .astype(np.uint8) for i in range(7)}
    jfa.write_fasta(tmp_path / "c.fa", [jfa.SeqRecord(k, "", v)
                                        for k, v in ctgs.items()])
    names = list(ctgs)
    lines = {1: [], 2: []}
    for q in range(300):
        a, b = rng.choice(7, 2) if q % 4 else (q % 7, q % 7)
        for m, c in ((1, a), (2, b)):
            flag = (16 if rng.random() < 0.5 else 0) | \
                (4 if q % 23 == 0 else 0)
            lines[m].append(f"q{q}\t{flag}\t{names[c]}\t1\t60\t10M\t*\t0\t0"
                            f"\tACGTACGTAC\t*")
    for m in (1, 2):
        (tmp_path / f"m{m}.sam").write_text("@HD\tVN:1.4\n"
                                           + "\n".join(lines[m]) + "\n")
    links = list(psc.collect_links(psam.read_sam(tmp_path / "m1.sam"),
                                   psam.read_sam(tmp_path / "m2.sam")))
    assert links == list(jsc.collect_links(
        jsam.read_sam(tmp_path / "m1.sam"), jsam.read_sam(tmp_path / "m2.sam")))
    gapped = [(a, b, int(g)) for (a, b), g in
              zip(links, rng.integers(-50, 300, len(links)))]
    for lk in (links, gapped):
        for kw in (dict(), dict(min_links=4, default_gap=7, min_gap=3)):
            paths = psc.build_scaffolds(lk, names, psc.ScaffoldParams(**kw))
            assert paths == jsc.build_scaffolds(lk, names,
                                                jsc.ScaffoldParams(**kw))
            assert any(len(pth) > 1 for pth in paths)
            got = psc.write_scaffolds(tmp_path / "p.fa", paths, ctgs,
                                      psc.ScaffoldParams(**kw))
            want = jsc.write_scaffolds(tmp_path / "j.fa", paths, ctgs,
                                       jsc.ScaffoldParams(**kw))
            assert [(r.name, r.descr, r.codes.tolist()) for r in got] == \
                [(r.name, r.descr, r.codes.tolist()) for r in want]
            assert (tmp_path / "p.fa").read_bytes() == \
                (tmp_path / "j.fa").read_bytes()
    psc.pescaffold(tmp_path / "m1.sam", tmp_path / "m2.sam",
                   tmp_path / "c.fa", tmp_path / "p.fa")
    jsc.pescaffold(tmp_path / "m1.sam", tmp_path / "m2.sam",
                   tmp_path / "c.fa", tmp_path / "j.fa")
    assert (tmp_path / "p.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    assert psc._end_of(True) == jsc._end_of(True) == "R"


def test_counts_and_dataset_readers_and_writers_match(tmp_path):
    from kit4b_tpu.align import rnaexpr as jre
    from kit4b_tpu.tools import mlds as jml
    from kit4b_tpu_torch.align import rnaexpr as pre
    from kit4b_tpu_torch.tools import mlds as pml
    (tmp_path / "c.csv").write_text(
        'Feature,"a", "b",c\n"g1",1,2.5,3\n"g2",4,5\nbad\n" g3 ",0,0,1e3\n')
    got, want = pre.load_counts_matrix(tmp_path / "c.csv"), \
        jre.load_counts_matrix(tmp_path / "c.csv")
    assert got[:2] == want[:2] == (["a", "b", "c"], ["g1", "g3"])
    np.testing.assert_array_equal(got[2], want[2])
    (tmp_path / "l.csv").write_text('"a",X\nb, "Y"\nonly\n')
    assert pml.load_sample_labels(tmp_path / "l.csv") == \
        jml.load_sample_labels(tmp_path / "l.csv") == {"a": "X", "b": "Y"}
    (tmp_path / "d.csv").write_text(
        'Feature,"a", "b",c\n"g1",1,2.5,3\n\n" g3 ",0,,1e3\n')
    for labels in (None, {"a": "X", "c": "Z"}):
        n = pml.transpose_dataset(tmp_path / "d.csv", tmp_path / "p.csv",
                                  labels, label_name="Class")
        assert n == jml.transpose_dataset(tmp_path / "d.csv",
                                          tmp_path / "j.csv", labels,
                                          label_name="Class") == (3, 2)
        assert (tmp_path / "p.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()
    lk = [{"features": ["f1", "f9"], "rows": 12}, {"features": ["x"],
                                                   "rows": 3}]
    pml.write_linkages_csv(tmp_path / "p.csv", lk)
    jml.write_linkages_csv(tmp_path / "j.csv", lk)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_config5_reads_are_the_tools_scripts():
    """tools/config5_bacterial.py's generator, step by step through the
    JAX package: the port's reads are its reads, renamed by pair."""
    from kit4b_tpu_torch.tools import config5
    seq, r1, r2 = config5.make_config5(12.0, 9.0)
    n = 12_000
    rng = np.random.default_rng(55)
    want = rng.integers(0, 4, n).astype(np.uint8)
    g = jfa.Genome.from_records([jfa.SeqRecord("bact1", "", want)])
    pairs = int(n * 9.0 / 300)
    j1, j2 = jsim.sim_reads(g, jsim.SimParams(
        n_reads=pairs, read_len=150, pe=True, pe_insert_min=250,
        pe_insert_max=500, error_mode="illumina", subs_rate=0.005, seed=5))
    dup = rng.choice(pairs, pairs // 10)
    j1 = j1 + [j1[i] for i in dup]
    j2 = j2 + [j2[i] for i in dup]
    np.testing.assert_array_equal(seq, want)
    for got, exp in ((r1, j1), (r2, j2)):
        assert len(got) == len(exp) == pairs + pairs // 10
        assert [(r.descr, r.codes.tolist()) for r in got] == \
            [(r.name, r.codes.tolist()) for r in exp]
    assert [r.name for r in r1] == [r.name for r in r2] == \
        [f"p{j + 1:07d}" for j in range(len(r1))]


def _pacbio_scale():
    """tools/pacbio_scale.py (the JAX package's tool) as a module."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "pacbio_scale.py"
    spec = importlib.util.spec_from_file_location("pacbio_scale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pacbio_readset_is_the_tools_script():
    """tools/pacbio_scale.py's corruption and the read loop of its main
    (lines 99-112) at a small size: the same genome, reads and truth."""
    from kit4b_tpu_torch.tools import pacbio_reads
    tool = _pacbio_scale()
    kbp, cov = 40.0, 1.5
    genome, reads, truth = pacbio_reads.simulate(kbp, cov)
    n = int(kbp * 1000)
    rng = np.random.default_rng(99)
    want = rng.integers(0, 4, n).astype(np.uint8)
    exp, total = [], 0
    while total < n * cov:
        span = int(rng.integers(10_000, 18_000))
        start = int(rng.integers(0, n - span))
        raw = tool.corrupt_pacbio(want[start:start + span], rng)
        exp.append((f"pb{len(exp)}|{start}|{span}", raw.tolist(),
                    (start, span)))
        total += span
    np.testing.assert_array_equal(genome, want)
    assert [(r.name, r.codes.tolist(), t) for r, t in zip(reads, truth)] \
        == exp
    assert len(exp) >= 4


def test_pacbio_identity_vs_truth_is_the_tools(lib):
    from kit4b_tpu_torch.tools import pacbio_reads
    tool = _pacbio_scale()
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 3_000).astype(np.uint8)
    for start, span in ((0, 1_200), (1_500, 900)):
        read = pacbio_reads.corrupt_pacbio(genome[start:start + span], rng)
        want = tool.identity_vs_truth(read, genome, start, span, band=256)
        got = pacbio_reads.identity_vs_truth(read, genome, start, span,
                                             band=256, device="cpu")
        assert got == want and got > 0.3


@pytest.fixture
def pacbio_reads_index(lib):
    """Twelve 600 bp reads of a 2 kbp genome (one with Ns, one
    reverse-complemented) as both packages' read index."""
    from kit4b_tpu.pacbio import ecreads as jec
    from kit4b_tpu_torch.pacbio import ecreads as pec
    rng = np.random.default_rng(4242)
    ref = rng.integers(0, 4, 2_000).astype(np.uint8)
    codes = []
    for i, s in enumerate(rng.integers(0, 1_400, 12)):
        r = ref[s:s + 600].copy()
        r[rng.random(600) < 0.02] = rng.integers(0, 4)
        if i == 3:
            r[100:110] = 4
        if i == 5:
            r = pdna.revcomp(r)
        codes.append(r)
    jidx, jg = jec.build_read_index(
        [jfa.SeqRecord(f"r{i}", "", c) for i, c in enumerate(codes)])
    pidx, pg = pec.build_read_index(
        [pfa.SeqRecord(f"r{i}", "", c) for i, c in enumerate(codes)])
    return codes, (jidx, jg), (pidx, pg)


def test_build_read_index_matches(pacbio_reads_index):
    _, (jidx, jg), (pidx, pg) = pacbio_reads_index
    assert pg.names == jg.names
    for a, b in ((pg.starts, jg.starts), (pg.lengths, jg.lengths),
                 (pg.seq, jg.seq), (pidx.sa_clean, jidx.sa_clean),
                 (pidx.lut, jidx.lut)):
        np.testing.assert_array_equal(a, b)
    assert pidx.lut_k == jidx.lut_k


@pytest.mark.parametrize("stride,cap", [(16, 32), (3, 4), (1, 16)])
def test_seed_hits_match(pacbio_reads_index, stride, cap):
    from kit4b_tpu.align import blitz as jbl
    from kit4b_tpu_torch.align import blitz as pbl
    codes, (jidx, _), (pidx, _) = pacbio_reads_index
    for q in (codes[0], codes[3][:100], pdna.revcomp(codes[7]),
              codes[1][:5]):
        want = jbl._seed_hits(jidx, q, stride, max_per_seed=cap)
        got = pbl._seed_hits(pidx, q, stride, max_per_seed=cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # a sampled window that starts on an N keys past the bucket table:
    # the JAX package raises there, and so does its copy
    if stride != 16:
        for fn, idx in ((jbl._seed_hits, jidx), (pbl._seed_hits, pidx)):
            with pytest.raises(IndexError):
                fn(idx, codes[3], stride, max_per_seed=cap)


@pytest.mark.parametrize("kw", [dict(), dict(band=256, min_seed_cores=8),
                                dict(core_step=1, max_candidates=3)])
def test_candidates_match(pacbio_reads_index, kw):
    from kit4b_tpu.pacbio import ecreads as jec
    from kit4b_tpu_torch.pacbio import ecreads as pec
    codes, (jidx, jg), (pidx, pg) = pacbio_reads_index
    for self_id, q in ((0, codes[0]), (5, codes[5]), (-1, codes[2]),
                       (-1, pdna.revcomp(codes[5]))):
        want = jec._candidates(jidx, jg, q, self_id, jec.ECParams(**kw))
        got = pec._candidates(pidx, pg, q, self_id, pec.ECParams(**kw))
        assert got == want
    assert got


def test_self_rc_diag_matches():
    from kit4b_tpu.pacbio import pbfilter as jpf
    from kit4b_tpu_torch.pacbio import pbfilter as ppf
    rng = np.random.default_rng(77)
    arm = rng.integers(0, 4, 500).astype(np.uint8)
    seqs = [np.concatenate([arm, pdna.revcomp(arm)]),
            np.concatenate([arm, rng.integers(0, 4, 37).astype(np.uint8),
                            pdna.revcomp(arm[:300])]),
            rng.integers(0, 4, 800).astype(np.uint8), arm[:20], arm[:40]]
    nn = seqs[0].copy()
    nn[rng.integers(0, len(nn), 30)] = 4
    seqs.append(nn)
    got = [ppf._self_rc_diag(s) for s in seqs]
    assert got == [jpf._self_rc_diag(s) for s in seqs]
    assert got[0] is not None and got[2] is None
    assert [ppf._self_rc_diag(s, k=8, min_votes=2) for s in seqs] == \
        [jpf._self_rc_diag(s, k=8, min_votes=2) for s in seqs]


def test_consensus_builder_matches():
    """Hand-made overlaps with runs of M, D and I, N and 0x0F codes in the
    target, competing insertions and a deletion majority."""
    from kit4b_tpu.pacbio import consensus as jc
    from kit4b_tpu.pacbio.sswd import SWAlignment as JAln
    from kit4b_tpu_torch.pacbio import consensus as pc
    rng = np.random.default_rng(31)
    probe = rng.integers(0, 4, 60).astype(np.uint8)
    probe[[5, 6]] = 4
    alns = [(0, 0, [("M", 20), ("I", 2), ("M", 10), ("D", 3), ("M", 20)]),
            (4, 2, [("M", 16), ("I", 2), ("M", 10), ("D", 3), ("M", 10)]),
            (10, 0, [("M", 10), ("I", 1), ("M", 10), ("D", 3), ("M", 25)]),
            (30, 5, [("M", 5), ("D", 4), ("M", 21)])]
    jb, pb = jc.ConsensusBuilder(probe), pc.ConsensusBuilder(probe)
    for ps, ts, ops in alns:
        pl = sum(n for op, n in ops if op != "I")
        tl = sum(n for op, n in ops if op != "D")
        t = rng.integers(0, 4, ts + tl + 3).astype(np.uint8)
        t[ts + 3], t[ts + 8] = 4, 0x0F
        a = JAln(1, ps, ps + pl, ts, ts + tl, ops)
        jb.add(a, t)
        pb.add(a, t)
    for k in ("base_votes", "del_votes", "cov", "ins_cov", "n_overlaps"):
        np.testing.assert_array_equal(getattr(pb, k), getattr(jb, k))
    for cov in (1, 2, 3, 5):
        np.testing.assert_array_equal(pb.call(cov), jb.call(cov))


def test_bed_contains_write_and_map_loci_match(tmp_path):
    """io.bed's `contains`, `write_bed` and `map_loci_to_features` (the
    maploci and rnade copies): nested, touching and unnamed features."""
    from kit4b_tpu.io import bed as jbed
    from kit4b_tpu_torch.io import bed as pbed
    feats = [("c1", 100, 300, "gA", 5, "+"), ("c1", 150, 200, "", 0, "-"),
             ("c1", 300, 400, "gC", 0, "+"), ("c2", 0, 50, "gD", 1, "-")]
    jb = jbed.BedFile([jbed.BedFeature(*f) for f in feats])
    pb = pbed.BedFile([pbed.BedFeature(*f) for f in feats])
    for chrom, pos in (("c1", 99), ("c1", 100), ("c1", 299), ("c1", 300),
                       ("c1", 170), ("c2", 49), ("c3", 1)):
        assert [dataclasses.asdict(f) for f in pb.contains(chrom, pos)] == \
            [dataclasses.asdict(f) for f in jb.contains(chrom, pos)]
    jbed.write_bed(tmp_path / "j.bed", jb.features)
    pbed.write_bed(tmp_path / "p.bed", pb.features)
    assert (tmp_path / "p.bed").read_bytes() == \
        (tmp_path / "j.bed").read_bytes()
    sam = tmp_path / "m.sam"
    with psam.SamWriter(sam, ["c1", "c2"], [1000, 100]) as w:
        for i, (rname, pos, flag) in enumerate([
                ("c1", 1, 0), ("c1", 150, 16), ("c1", 290, 0),
                ("c1", 401, 0), ("c2", 10, 0), ("*", 0, 4)]):
            w.write(psam.SamAlignment(f"r{i}", flag, rname, pos, 60,
                                      "20M" if pos else "*", seq="A" * 20))
    got = pbed.map_loci_to_features(pb, psam.read_sam(sam))
    assert got == jbed.map_loci_to_features(jb, jsam.read_sam(sam))
    assert got == ({"gA": 2, "c1:150-200": 1, "gC": 1, "gD": 1}, 2)


def test_gene_bed_and_loci_csv_readers_match(tmp_path):
    from kit4b_tpu.io import biobed as jbio
    from kit4b_tpu.tools import convert as jconv
    from kit4b_tpu_torch.io import biobed as pbio
    from kit4b_tpu_torch.tools import convert as pconv
    (tmp_path / "g.bed").write_text(
        "# comment\ntrack name=x\nbrowser position c1\n\n"
        "c1\t100\t900\tg1\t0\t-\t150\t850\t0\t2\t200,300,\t0,500,\n"
        "c1 1000 2000 g2\n"
        "c2\t5\t60\n")
    for a, b in zip(pbio.load_gene_bed(tmp_path / "g.bed"),
                    jbio.load_gene_bed(tmp_path / "g.bed")):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("exon_starts", "exon_ends"):
            np.testing.assert_array_equal(a.pop(k), b.pop(k))
        assert a == b
    (tmp_path / "l.csv").write_text(
        '"SrcID","ElType","Species","Chrom","Start","End","Len"\n'
        '1,"exon","sp","c1",10,19,10,"-"\n"2","x","sp",c2,0,4,5\n'
        'bad,row\n3,"x","sp","c3",7,8,2\n')
    assert pconv.read_loci_csv(tmp_path / "l.csv") == \
        jconv.read_loci_csv(tmp_path / "l.csv")


def test_rnade_numeric_helpers_match():
    from kit4b_tpu.align import rnade as jde
    from kit4b_tpu_torch.align import rnade as pde
    rng = np.random.default_rng(12)
    c = rng.poisson(5, (40, 10)).astype(np.float64)
    e = rng.poisson(3, (40, 10)).astype(np.float64)
    mask = rng.random((40, 10)) < 0.7
    mask[0] = False
    np.testing.assert_array_equal(pde._pearson_rows(c, e, mask),
                                  jde._pearson_rows(c, e, mask))
    for i in range(5):
        assert pde._laplace_pearson(c[i], e[i], mask[i]) == \
            jde._laplace_pearson(c[i], e[i], mask[i])
    a, b, cc, d = (rng.integers(0, 50, 30) for _ in range(4))
    chi = pde._chi2_2x2(a, b, cc, d)
    np.testing.assert_array_equal(chi, jde._chi2_2x2(a, b, cc, d))
    np.testing.assert_array_equal(pde._erfc(np.sqrt(chi / 2)),
                                  jde._erfc(np.sqrt(chi / 2)))
    np.testing.assert_array_equal(pde._chi2_pvalue_1dof(chi),
                                  jde._chi2_pvalue_1dof(chi))


def test_magicbench_profile_replay_helpers_match():
    from kit4b_tpu.align import magicbench as jmb
    from kit4b_tpu_torch.align import magicbench as pmb
    rng = np.random.default_rng(21)
    target = rng.integers(0, 4, 400).astype(np.uint8)
    read = target[50:110].copy()
    read[[3, 4, 40]] ^= 1
    for cig, start in (("60M", 50), ("20M2I38M", 50), ("30M5D30M", 50),
                       ("10M3N50M", 50), ("1P60M", 50), ("5S55M", 50),
                       ("60M", 380)):
        ops = pmb.parse_cigar(cig)
        assert pmb._refine_profile(ops, read, target, start) == \
            jmb._refine_profile(ops, read, target, start)
    for prof, start, n in (("20=1X19=", 10, 40), ("5=2I3X5D10=", 7, 20),
                           ("10=3N5H2S", 0, 20), ("40=", 370, 40),
                           ("10=", 0, 20)):
        ops = pmb.parse_cigar(prof)
        got = pmb._apply_profile(ops, target, start, n)
        want = jmb._apply_profile(ops, target, start, n)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_blitz_psl_writer_matches(tmp_path):
    """write_psl on hand-made hits: blocks given and not, a hit of a
    query or target missing from the length tables."""
    from kit4b_tpu.align import blitz as jbl
    from kit4b_tpu_torch.align import blitz as pbl
    rows = [("q1", 0, 50, "c1", 100, 150, "+", 48, 2, 92),
            ("q1", 5, 60, "c2", 10, 70, "-", 50, 3, 90, 1, 1, 5, 10,
             [(5, 10, 20), (30, 40, 30)]),
            ("q2", 0, 10, "c9", 0, 10, "+", 10, 0, 10)]
    out = {}
    for name, mod in (("j", jbl), ("p", pbl)):
        hits = [mod.BlitzHit(*r) for r in rows]
        mod.write_psl(tmp_path / name, hits, {"q1": 60}, {"c1": 500,
                                                           "c2": 80})
        out[name] = (tmp_path / name).read_bytes()
    assert out["p"] == out["j"]


def test_readstats_summary_and_empty_inputs_match(tmp_path):
    from kit4b_tpu.align import readstats as jrs
    from kit4b_tpu_torch.align import readstats as prs
    assert prs.ReadStats().summary() == jrs.ReadStats().summary()
    assert prs.compute_contaminant_stats([]) == \
        jrs.compute_contaminant_stats([])
    recs = [pfa.SeqRecord("a", "", np.full(3, 4, np.uint8))]
    p = prs.compute_readstats(recs, kmer_len=4)
    j = jrs.compute_readstats([jfa.SeqRecord("a", "", np.full(
        3, 4, np.uint8))], kmer_len=4)
    assert p.summary() == j.summary() and p.kmer_counts == j.kmer_counts


HAPLOTYPE_MODULES = ("kmer/pba.py", "kmer/pbautils2.py",
                     "kmer/callhaplotypes.py", "kmer/haplogroups.py",
                     "kmer/allelescores.py", "kmer/dgtqtl.py",
                     "kmer/snpmarkers.py", "kmer/gbs.py",
                     "tools/snpsfmt.py", "tools/pangenes.py",
                     "tools/seghaps.py")


@pytest.mark.parametrize("path", HAPLOTYPE_MODULES)
def test_haplotype_modules_are_copies(path):
    """The PBA and haplotype family's modules, copied whole: the same code
    statement for statement (only the module docstring says it is the
    port's), so every tie rule, rounding and iteration order is the JAX
    package's; tests/test_torch_haplotypes.py runs them side by side."""
    import ast
    import importlib
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent

    def body(pkg):
        tree = ast.parse((repo / pkg / path).read_text())
        doc = tree.body[0]
        assert isinstance(doc, ast.Expr) and isinstance(doc.value,
                                                        ast.Constant)
        return [ast.dump(n) for n in tree.body[1:]], doc.value.value
    jb, _ = body("kit4b_tpu")
    pb, pdoc = body("kit4b_tpu_torch")
    assert pb == jb
    assert "port's copy of kit4b_tpu/" + path in " ".join(pdoc.split())
    name = path[:-3].replace("/", ".")
    jm = importlib.import_module(f"kit4b_tpu.{name}")
    pm = importlib.import_module(f"kit4b_tpu_torch.{name}")
    public = sorted(n for n in vars(jm) if not n.startswith("__"))
    assert sorted(n for n in vars(pm) if not n.startswith("__")) == public
