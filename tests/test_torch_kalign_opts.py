"""kalign's post-alignment phases, filters and options in the port against
the JAX package, bit for bit, on the options golden's workload
(kit4b_tpu_torch/tools/make_kalign_opts_golden.py): the multiloci hit
lists that `_force_full` keeps, every phase of align.phases (-x, -6,
--lociconstraints, --mlmode 2/3/4/5, the side files) and
`filter_alignments` (-Z, -z, -B, -5) fed the same (rec, res) list in both
packages, with inputs built to reach each shortcut: a read trimmed on both
flanks and one that cannot be trimmed, a -6 read that cannot reach the
rate, --mlmode 3 reads tied between clusters, a -5 cap hit on both
strands, a BED feature that ends exactly at a read's start; then the CLI's
output bytes per flag (`python -m kit4b_tpu_torch kalign --device cpu`
against `python -m kit4b_tpu kalign`), and the paired-end route, which
ignores the single-end phases and filters and refuses BAM output."""
import copy
import gzip

import numpy as np
import pytest

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.align import phases as jph
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.io.bed import BedFile as JBed
from kit4b_tpu.io.fasta import SeqRecord as JRec
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.align import phases as pph
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.bed import BedFile as PBed
from kit4b_tpu_torch.io.fasta import read_seqs, write_fasta
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401

RES_FIELDS = ("nar", "strand", "pos", "mm", "n_low", "nxt_mm", "cigar",
              "trim_left", "trim_right", "secondary")


@pytest.fixture(scope="module")
def work():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    g, se, bis, pairs, bed, cons = mg.workload()
    return g, SfxIndex.build(g), se, pairs, bed, cons


@pytest.fixture(scope="module")
def listed(work):
    """Both packages' -s 6 full-stats streams (`_force_full`, as --mlmode
    sets it) of the workload's single-end reads."""
    from kit4b_tpu.index.sfx_index import SfxIndex as JSfx
    from kit4b_tpu.io.fasta import Genome as JGenome
    g, idx, se, _, _, _ = work
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    out = []
    for mod, index, kw in ((jk, JSfx.build(jg), {}),
                           (pk, idx, {"device": "cpu"})):
        al = mod.KAligner(index, max_subs=6, batch_size=mg.BATCH, **kw)
        al._force_full = True
        assert not al._use_compact()
        out.append(list(al.align_records(se)))
    return out


def _fields(res):
    return tuple(getattr(res, f) for f in RES_FIELDS) + (
        None if res.multi_ids is None else res.multi_ids.tolist(),)


def _as_jax(stream):
    """The port's (rec, res) list as the JAX package's types, copied."""
    out = []
    for rec, res in stream:
        r = jk.AlignResult(res.nar)
        for f in RES_FIELDS:
            setattr(r, f, getattr(res, f))
        r.multi_ids = None if res.multi_ids is None else res.multi_ids.copy()
        out.append((JRec(rec.name, rec.descr, rec.codes.copy(), rec.qual),
                    r))
    return out


def _same(jstream, pstream):
    assert len(jstream) == len(pstream)
    for (jr, ja), (pr, pa) in zip(jstream, pstream):
        assert jr.name == pr.name
        np.testing.assert_array_equal(jr.codes, pr.codes)
        assert _fields(ja) == _fields(pa), pr.name


def _both(listed):
    """(JAX copy, port copy) of the port's stream: the same inputs."""
    return _as_jax(listed[1]), copy.deepcopy(listed[1])


def test_force_full_streams_match_jax(listed):
    _same(*listed)
    multi = [res for _, res in listed[1] if res.nar == "multi"]
    assert multi and all(len(r.multi_ids) >= 2 for r in multi)


@pytest.mark.parametrize("klen", [10, 15])
def test_auto_trim_flanks_matches_jax(work, listed, klen):
    seq = work[0].seq
    j, p = _both(listed)
    assert jph.auto_trim_flanks(j, seq, klen) == \
        pph.auto_trim_flanks(p, seq, klen)
    _same(j, p)
    res = {rec.name: r for rec, r in p}
    assert any(r.trim_left and r.trim_right for r in res.values())
    assert any(r.trim_left and not r.trim_right for r in res.values())
    assert res["x_untrimmable"].nar == pph.NAR_TRIM


@pytest.mark.parametrize("subs", [2, 3])
def test_pcr5_primer_correct_matches_jax(work, listed, subs):
    seq = work[0].seq
    j, p = _both(listed)
    before = {rec.name: (res.mm, rec.codes.copy()) for rec, res in p}
    st = pph.pcr5_primer_correct(p, seq, subs, 12)
    assert jph.pcr5_primer_correct(j, seq, subs, 12) == st
    _same(j, p)
    assert st["corrected_reads"] > 0
    fixed = {rec.name for rec, _ in p
             if not np.array_equal(rec.codes, before[rec.name][1])}
    # on both strands; and at -s 2, reads that cannot reach the rate
    # left as they were
    assert {n for n in fixed if n.startswith("p6_")}
    assert any(r.nar == "accepted" and r.mm > subs and
               rec.name.startswith("p6_") for rec, r in p) == (subs == 2)
    strands = {r.strand for rec, r in p if rec.name in fixed}
    assert strands == {0, 1}


def test_read_records_own_their_codes(tmp_path, work):
    """pcr5 writes corrections into rec.codes: every record read from a
    file holds a private, writable array."""
    fa = tmp_path / "r.fa"
    write_fasta(fa, work[2][:50])
    recs = list(read_seqs(fa))
    assert all(r.codes.flags.writeable and r.codes.flags.owndata
               for r in recs)


def test_loci_constraints_match_jax(tmp_path, work, listed):
    g = work[0]
    (tmp_path / "c.csv").write_text(work[5])
    from kit4b_tpu.io.fasta import Genome as JGenome
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    cj = jph.load_loci_constraints(tmp_path / "c.csv", jg)
    cp = pph.load_loci_constraints(tmp_path / "c.csv", g)
    assert cj == cp and len(cp) == 3
    j, p = _both(listed)
    n = pph.identify_constraint_violations(p, cp)
    assert jph.identify_constraint_violations(j, cj) == n > 0
    _same(j, p)


@pytest.mark.parametrize("mode", [2, 3, 4, 5])
def test_mlmode_matches_jax(listed, mode):
    j, p = _both(listed)
    if mode == 2:
        n = pph.assign_multi_random(p)
        assert jph.assign_multi_random(j) == n > 0
    elif mode == 5:
        j, p = jph.expand_multi_all(j), pph.expand_multi_all(p)
        assert any(r.secondary for _, r in p)
    else:
        n = pph.assign_multi_matches(p)
        assert jph.assign_multi_matches(j) == n > 0
        # the reads in the tied unit stay multi
        assert any(r.nar == "multi" for rec, r in p
                   if rec.name.startswith("mB"))
    _same(j, p)


def test_side_files_match_jax(tmp_path, listed):
    j, p = _both(listed)
    for fn in ("report_none_aligned", "report_multi_align"):
        for tag, mod, stream in (("j", jph, j), ("p", pph, p)):
            n = getattr(mod, fn)(tmp_path / f"{tag}{fn}.fa.gz"
                                 if fn.endswith("aligned") else
                                 tmp_path / f"{tag}{fn}.fa", stream)
            assert n > 0
    for fn, op in (("report_none_aligned.fa.gz", gzip.open),
                   ("report_multi_align.fa", open)):
        with op(tmp_path / f"j{fn}", "rb") as a, \
                op(tmp_path / f"p{fn}", "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("kw", [
    dict(chrom_include=["chr2"]), dict(chrom_exclude=["2$"]),
    dict(chrom_include=["1"], chrom_exclude=["chr1"]),
    dict(bed=True), dict(max_pcr_dups=2), dict(max_pcr_dups=1, bed=True,
                                               chrom_exclude=["chr2"])])
def test_filter_alignments_matches_jax(tmp_path, work, listed, kw):
    from kit4b_tpu.io.fasta import Genome as JGenome
    g, bed_text = work[0], work[4]
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    kw = dict(kw)
    beds = (None, None)
    if kw.pop("bed", False):
        (tmp_path / "p.bed").write_text(bed_text)
        beds = (JBed.load(tmp_path / "p.bed"), PBed.load(tmp_path / "p.bed"))
    j, p = _both(listed)
    j = list(jk.filter_alignments(j, jg, priority_bed=beds[0], **kw))
    p = list(pk.filter_alignments(p, g, priority_bed=beds[1], **kw))
    _same(j, p)
    before = {rec.name: r.nar for rec, r in listed[1]}
    demoted = [rec.name for rec, r in p
               if before[rec.name] == "accepted" and r.nar == "nohit"]
    assert demoted
    if kw.get("max_pcr_dups") == 2:
        # the cap hit on both strands: stacks of 5 (+), 4 and 3 (-)
        assert sorted(n.rsplit("_", 2)[1] for n in demoted
                      if n.startswith("dup")) == ["0"] * 3 + ["1"] * 3
    if beds[1] is not None:
        ci, p0, strand, _ = mg.DUP_STACKS[0]
        assert [f.name for f in beds[1].overlapping("chr1", p0 - 1, p0)] \
            == ["ends_at_dup"]
        assert beds[1].overlapping("chr1", p0, p0 + 100) == []
        assert f"dup{ci}_{p0}_{strand}_0" in demoted


def _cli_files(tmp_path, work, flags, reads=None, pe=False, rc=0):
    """Both CLIs' output files (name -> bytes) of one kalign run, each
    exiting with `rc`."""
    g, _, se, pairs, bed, cons = work
    tmp_path.mkdir(exist_ok=True)
    fa = tmp_path / "genome.fa"
    from kit4b_tpu_torch.io.fasta import SeqRecord
    write_fasta(fa, [SeqRecord(g.names[i], "", g.chrom_codes(i))
                     for i in range(g.nchroms())])
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        r1 = d / "r.fa"
        write_fasta(r1, pairs[0][:120] if pe else (reads or se[:400]))
        if pe:
            write_fasta(d / "r2.fa", pairs[1][:120])
        (d / "p.bed").write_text(bed)
        (d / "c.csv").write_text(cons)
        kix = d / "g.kix"
        assert main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        out = d / ("out.bam" if "{bam}" in flags else "out.sam")
        argv = ["kalign", "-i", str(r1), "-I", str(kix), "-o", str(out),
                "-b", "128", *[f.replace("{d}", str(d)) for f in flags
                               if f != "{bam}"]]
        assert main(argv + extra) == rc, tag
        outs[tag] = {p.name: p.read_bytes() for p in d.iterdir()
                     if p.name not in ("r.fa", "r2.fa", "p.bed", "c.csv")
                     and ".kix" not in p.name}
    return outs


CLI_FLAGS = {
    "x10": ["-x", "10", "-O", "{d}/s.csv", "-M", "1"],
    "6": ["-s", "2", "-6", "4", "-O", "{d}/s.csv", "-M", "1"],
    "ml2": ["--mlmode", "2", "--nonealign", "{d}/na.fa", "--multialign",
            "{d}/ml.fa"],
    "ml3": ["--mlmode", "3", "-O", "{d}/s.csv"],
    "ml4": ["--mlmode", "4", "-M", "1"],
    "ml5": ["--mlmode", "5", "-O", "{d}/s.csv"],
    "cons": ["--lociconstraints", "{d}/c.csv", "-O", "{d}/s.csv"],
    "Zz": ["-Z", "chr", "-z", "chr1", "-O", "{d}/s.csv"],
    "B5": ["-B", "{d}/p.bed", "-5", "1", "-M", "1"],
}


@pytest.mark.parametrize("name", list(CLI_FLAGS))
def test_cli_flag_bytes_match_jax(tmp_path, work, name):
    extra = [r for r in work[2] if r.name.startswith(("dup", "p6_", "x",
                                                      "mA", "mB", "eA"))]
    outs = _cli_files(tmp_path, work, CLI_FLAGS[name],
                      reads=work[2][:250] + extra)
    assert outs["port"] == outs["jax"]
    assert "out.sam" in outs["port"]


def test_pe_route_ignores_se_flags(tmp_path, work, capsys):
    flags = ["-u", "{d}/r2.fa", "-U", "1", "-x", "10", "-6", "2", "-5", "1",
             "--mlmode", "3", "-Z", "chr2", "-B", "{d}/p.bed", "-g",
             "{d}/cov.wig", "-3", "{d}/o.pba.npz"]
    outs = _cli_files(tmp_path / "a", work, flags, pe=True)
    pba = {t: outs[t].pop("o.pba.npz") for t in outs}   # zip timestamps
    assert outs["port"] == outs["jax"]
    assert len(pba["port"]) > 0
    assert "do not apply to paired ends" in capsys.readouterr().err
    # the same run without the single-end flags writes the same SAM
    plain = _cli_files(tmp_path / "b", work, ["-u", "{d}/r2.fa", "-U", "1",
                                              "-6", "2"], pe=True)
    assert plain["port"]["out.sam"] == outs["port"]["out.sam"]


def test_pe_route_refuses_bam(tmp_path, work, capsys):
    """The JAX package writes SAM text into the .bam; the port refuses,
    naming the finding."""
    with pytest.raises(AssertionError, match="port"):
        _cli_files(tmp_path, work, ["-u", "{d}/r2.fa", "{bam}"], pe=True)
    assert (tmp_path / "jax" / "out.bam").read_bytes().startswith(b"@HD\t")
    assert not (tmp_path / "port" / "out.bam").exists()
    assert "queue C" in capsys.readouterr().err


def test_disnp_with_bam_output_fails_as_in_jax(tmp_path, work, capsys):
    """-X reads the run's output back as SAM text: with -o *.bam both
    packages write the BAM, then fail on its bytes (ROADMAP.md queue C)."""
    outs = _cli_files(tmp_path, work, ["{bam}", "-S", "{d}/s.csv", "-X",
                                       "{d}/d"], reads=work[2][:300], rc=1)
    assert capsys.readouterr().err.count(
        "codec can't decode byte 0x8b") == 2
    assert outs["port"] == outs["jax"] and "out.bam" in outs["port"]
