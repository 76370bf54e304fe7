"""Paired-end SAM and VCF from the port against the JAX package's, byte for
byte: `PeAligner.write_sam_fast` on one PePair stream (-M 0 and -M 1, the
SNP caller attached, qualities, and a pair of unequal mates that takes
`_pair_records_text`), and the CLI end to end: `simreads` (paired and
single ends, SNPs planted, a BED restriction) and `kalign -u` with -U 1-4,
-d/-D, -M 0/1 and -S .vcf/.csv, against `python -m kit4b_tpu`."""
import numpy as np
import pytest

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.align import pe as jpe
from kit4b_tpu.align import snp as jsnp
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.io.fasta import SeqRecord as JS
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.align import pe as ppe
from kit4b_tpu_torch.align import snp as psnp
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import Both, clean_genome


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def stream():
    """The port's pe-mode-3 stream of the golden's 2 x 150 bp pairs, with
    qualities on every other pair, and a pair of unequal mates (150 and
    120 bp) accepted and one unmapped, inserted into it."""
    g, idx, reads = mg.workload()
    recs1, recs2 = reads[150]
    rng = np.random.default_rng(4)
    for i in range(0, len(recs1), 2):
        recs1[i].qual = rng.integers(2, 41, 150).astype(np.uint8)
        recs2[i].qual = rng.integers(2, 41, 150).astype(np.uint8)
    pal = ppe.PeAligner(pk.KAligner(idx, batch_size=mg.BATCH,
                                    device="cpu"),
                        pair_min_len=mg.MIN_INS, pair_max_len=mg.MAX_INS,
                        pe_mode=3)
    out = list(pal.align_pairs(recs1, recs2))
    r = pk.AlignResult
    p0 = int(g.starts[1]) + 2000
    short = SeqRecord("unequal_mate2", "", g.seq[p0 + 280:p0 + 400].copy(),
                      rng.integers(2, 41, 120).astype(np.uint8))
    out.insert(100, (SeqRecord("unequal_mate1", "",
                               g.seq[p0:p0 + 150].copy()), short,
                     ppe.PePair(ppe.NAR_PE_ACCEPTED,
                                r("accepted", strand=0, pos=p0, mm=0),
                                r("accepted", strand=1, pos=p0 + 280, mm=0),
                                tlen=400)))
    out.insert(700, (recs1[5], short, ppe.PePair(ppe.NAR_PE_NOPAIR)))
    return g, idx, out


def _jax_stream(port_stream):
    """The same stream as JAX objects."""
    def res(r):
        return None if r is None else jk.AlignResult(
            r.nar, strand=r.strand, pos=r.pos, mm=r.mm, n_low=r.n_low)
    return [(JS(a.name, "", a.codes, a.qual), JS(b.name, "", b.codes, b.qual),
             jpe.PePair(pp.nar, res(pp.r1), res(pp.r2), tlen=pp.tlen,
                        rescued=pp.rescued))
            for a, b, pp in port_stream]


@pytest.mark.parametrize("emit_unmapped", [False, True])
def test_write_sam_fast_and_vcf_match_jax(tmp_path, stream, emit_unmapped):
    g, idx, port_stream = stream
    both = Both(g)
    jal, pal = both.aligners(mg.BATCH)
    outs = {}
    for tag, pe, snp, al, s in (
            ("jax", jpe, jsnp, jal, _jax_stream(port_stream)),
            ("port", ppe, psnp, pal, port_stream)):
        caller = snp.SnpCaller(al.index.genome,
                               snp.SnpOptions(min_snp_reads=2))
        sam, vcf = tmp_path / f"{tag}.sam", tmp_path / f"{tag}.vcf"
        stats = pe.PeAligner(al).write_sam_fast(
            sam, iter(s), cmdline="pe sam", emit_unmapped=emit_unmapped,
            snp_caller=caller)
        snp.write_snps_vcf(vcf, caller.call())
        outs[tag] = (sam.read_bytes(), vcf.read_bytes(), stats)
    assert outs["port"] == outs["jax"]
    sam_text = outs["port"][0].decode()
    assert "unequal_mate1\t" in sam_text and "\t120M\t" in sam_text
    assert ("\t*\t0\t0\t*\t" in sam_text) == emit_unmapped
    assert outs["port"][1].count(b"\n") > 100
    assert outs["port"][2]["rescued"] > 0


def _write_genome(path):
    g = clean_genome(60_000, seed=9)
    rng = np.random.default_rng(9)
    a = g.seq[:40_000].copy()
    b = g.seq[40_000:60_000].copy()
    b[5000:5600] = a[10_000:10_600]            # a copy across chromosomes
    a[rng.integers(0, 40_000, 20)] = 4
    write_fasta(path, [SeqRecord("chrA", "", a), SeqRecord("chrB", "", b)])


SIM_CASES = {
    "pe": ["-p", "-n", "400", "-l", "100", "-j", "200", "-J", "500", "-e",
           "illumina", "-z", "0.01", "-N", "3000", "-u", "{d}/truth.bed",
           "-S", "5", "-O", "{d}/r2.fa"],
    "se": ["-n", "300", "-l", "80", "-e", "static", "-X", "0.2", "-x", "4",
           "-a", "0.1", "-b", "0.1", "-R", "0.05", "-t", "{d}/feat.bed",
           "-d", "-s", "+", "-Q", "-S", "3"],
}


def _both_clis(tmp_path, argv):
    """Runs argv through both CLIs in their own directories; returns
    {tag: {file name: bytes}} of what each wrote there."""
    outs = {}
    for tag, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        before = set(d.iterdir())
        assert main([a.replace("{d}", str(d)) for a in argv]) == 0, tag
        outs[tag] = {p.name: p.read_bytes() for p in set(d.iterdir())
                     - before}
    return outs


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_cli_simreads_matches_jax(tmp_path, case):
    fa = tmp_path / "g.fa"
    _write_genome(fa)
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
        (tmp_path / tag / "feat.bed").write_text(
            "# features\nchrA\t1000\t9000\tf1\t0\t+\nchrB 2000 15000 f2\n")
    outs = _both_clis(tmp_path, ["simreads", "-i", str(fa), "-o",
                                 "{d}/r1." + ("fq" if case == "se" else "fa"),
                                 *SIM_CASES[case]])
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == (3 if case == "pe" else 1)


KALIGN_CASES = {   # pe mode, -d, -D, -M, SNP file
    "U1-vcf": ("1", "200", "500", "1", "out.vcf"),
    "U2-csv": ("2", "150", "450", "0", "out.csv"),
    "U3-vcf": ("3", "250", "500", "0", "out.vcf"),
    "U4-csv": ("4", "200", "500", "1", "out.csv"),
}


@pytest.mark.parametrize("case", list(KALIGN_CASES))
def test_cli_simreads_then_pe_kalign_match_jax(tmp_path, case):
    mode, dmin, dmax, fmt, snpf = KALIGN_CASES[case]
    fa = tmp_path / "g.fa"
    _write_genome(fa)
    sim = _both_clis(tmp_path, ["simreads", "-i", str(fa), "-o",
                                "{d}/r1.fa", *SIM_CASES["pe"]])
    assert sim["port"] == sim["jax"]
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        assert main(["index", "-i", str(fa), "-o", str(d / "g.kix")]) == 0
        argv = ["kalign", "-i", str(d / "r1.fa"), "-I", str(d / "g.kix"),
                "-o", str(d / "out.sam"), "-u", str(d / "r2.fa"), "-U",
                mode, "-d", dmin, "-D", dmax, "-M", fmt, "-b", "256", "-S",
                str(d / snpf), "-p", "2"]
        assert main(argv + extra) == 0, tag
        outs[tag] = [(d / f).read_bytes() for f in ("out.sam", snpf)]
    assert outs["port"] == outs["jax"]
    sam = outs["port"][0].decode().splitlines()
    body = [ln.split("\t") for ln in sam if not ln.startswith("@")]
    assert sum(int(c[1]) & 2 != 0 for c in body) > 0.8 * len(body) * (
        0.5 if fmt == "1" else 1)
    assert outs["port"][1].count(b"\n") > 2
