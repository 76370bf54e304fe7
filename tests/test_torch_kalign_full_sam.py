"""SAM from the port's full-stats route against the JAX package's, byte for
byte: the per-record `write_sam` (CIGARs, NM with the indel bases, the
MAPQ rule, -M 0/1, the SNP pileup fed by plain accepted reads, -O stats),
`write_sam_fast` on an aligner with a rescue on, and the CLI `kalign` with
-y, -l and -C (`python -m kit4b_tpu_torch --device cpu` against
`python -m kit4b_tpu`) on the full-stats golden's genome and reads; and the
refusal of genomes whose int32 locus ids wrap."""
import copy

import numpy as np
import pytest

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.align import phases as jph
from kit4b_tpu.align import snp as jsnp
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.align import phases as pph
from kit4b_tpu_torch.align import snp as psnp
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord, write_fasta
from kit4b_tpu_torch.tools import make_kalign_full_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import Both

YLC = dict(micro_indel=20, splice_max=10_000, chimeric_pct=50)


@pytest.fixture(scope="module")
def golden_inputs():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    g, _, se, _ = mg.workload()
    rng = np.random.default_rng(5)
    for rec in se[::4]:
        rec.qual = rng.integers(2, 41, len(rec.codes)).astype(np.uint8)
    return g, Both(g), se


@pytest.fixture(scope="module")
def aligned(golden_inputs):
    """Both packages' -y -l -C streams of the golden's reads, listed."""
    _, both, se = golden_inputs
    return [list(al.align_records(se)) for al in both.aligners(256, **YLC)]


@pytest.mark.parametrize("unmapped,snps,stats", [
    (True, False, False), (False, False, False), (True, True, True)])
def test_write_sam_matches_jax(tmp_path, golden_inputs, aligned, unmapped,
                               snps, stats):
    g, both, se = golden_inputs
    outs = []
    for tag, stream, snp, idx in zip(("jax", "port"), aligned, (jsnp, psnp),
                                     (both.jidx, both.idx)):
        mod = jk if tag == "jax" else pk
        caller = snp.SnpCaller(idx.genome, snp.SnpOptions(min_snp_reads=2)) \
            if snps else None
        sam, csv = tmp_path / f"{tag}.sam", tmp_path / f"{tag}.csv"
        st = mod.write_sam(sam, idx, stream, cmdline="a b",
                           emit_unmapped=unmapped, snp_caller=caller,
                           stats_path=csv if stats else None)
        outs.append([dict(st), sam.read_bytes(),
                     csv.read_bytes() if stats else None,
                     caller._counts.tobytes() if snps else None])
    assert outs[0] == outs[1]
    body = [ln.split(b"\t") for ln in outs[1][1].splitlines()
            if not ln.startswith(b"@")]
    mapq = {c[5]: int(c[4]) for c in body if c[2] != b"*"}
    assert any(b"N" in c and q < 254 for c, q in mapq.items())
    assert any(b"D" in c and q < 254 for c, q in mapq.items())
    assert (len(body) == len(se)) == unmapped


def test_write_sam_after_orphan_removal_matches_jax(tmp_path,
                                                   golden_inputs, aligned):
    """The demoted reads write as unmapped and count under their own
    class."""
    g, both, se = golden_inputs
    outs = []
    for tag, stream, ph, idx in zip(("jax", "port"), aligned, (jph, pph),
                                    (both.jidx, both.idx)):
        stream = copy.deepcopy(stream)
        n = [ph.remove_orphan_junctions(stream, k)
             for k in ("splice", "indel")]
        sam = tmp_path / f"{tag}.sam"
        st = (jk if tag == "jax" else pk).write_sam(sam, idx, stream)
        outs.append((n, dict(st), sam.read_bytes()))
    assert outs[0] == outs[1]
    assert outs[1][1][pph.NAR_ORPHAN_SPLICE] == outs[1][0][0] > 0


def test_write_sam_refuses_bam(tmp_path, golden_inputs, aligned):
    """A .bam path, once refused, now writes BAM as in JAX: the -y -l -C
    stream with its CIGARs, coordinate-sorted with a BAI, equal to the JAX
    package's bytes."""
    _, both, se = golden_inputs
    outs = []
    for tag, stream, idx in zip(("jax", "port"), aligned,
                                (both.jidx, both.idx)):
        mod = jk if tag == "jax" else pk
        st = mod.write_sam(tmp_path / f"{tag}.bam", idx, stream,
                           cmdline="a b", bam_index=True)
        outs.append((dict(st), (tmp_path / f"{tag}.bam").read_bytes(),
                     (tmp_path / f"{tag}.bam.bai").read_bytes()))
    assert outs[0] == outs[1]


def test_write_sam_fast_with_a_rescue_matches_jax(tmp_path, golden_inputs):
    """write_sam_fast on an aligner with a rescue on takes the per-record
    route in both packages."""
    g, both, se = golden_inputs
    sams = []
    for tag, al, mod, idx in zip(("jax", "port"),
                                 both.aligners(128, chimeric_pct=50),
                                 (jk, pk), (both.jidx, both.idx)):
        sam = tmp_path / f"{tag}.sam"
        mod.write_sam_fast(sam, idx, al, se[:300], cmdline="c")
        sams.append(sam.read_bytes())
    assert sams[0] == sams[1]
    assert any(b"S" in ln.split(b"\t")[5] for ln in sams[1].splitlines()
               if not ln.startswith(b"@"))


CLI_CASES = {
    "y20-C50": ["-y", "20", "-C", "50"],
    "l10000": ["-l", "10000"],
    "ylC-M1-S-O": ["-y", "20", "-l", "10000", "-C", "50", "-M", "1", "-S",
                   "{d}/snps.vcf", "-O", "{d}/stats.csv", "-p", "2"],
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_kalign_rescues_match_jax(tmp_path, golden_inputs, name):
    g, _, se = golden_inputs
    fa, reads = tmp_path / "genome.fa", tmp_path / "reads.fa"
    write_fasta(fa, [SeqRecord(n, "", g.chrom_codes(i))
                     for i, n in enumerate(g.names)])
    write_fasta(reads, se)
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        kix = d / "genome.kix"
        assert main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        argv = ["kalign", "-i", str(reads), "-I", str(kix), "-o",
                str(d / "out.sam"), "-b", "256",
                *[f.replace("{d}", str(d)) for f in CLI_CASES[name]]]
        assert main(argv + extra) == 0, tag
        outs[tag] = {p.name: p.read_bytes() for p in d.iterdir()
                     if p.suffix in (".sam", ".vcf", ".csv")}
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == (3 if "-S" in CLI_CASES[name] else 1)
    cigars = b" ".join(ln.split(b"\t")[5] for ln in
                       outs["port"]["out.sam"].splitlines()
                       if not ln.startswith(b"@"))
    assert (b"N" in cigars) == ("-l" in CLI_CASES[name])
    assert (b"S" in cigars) == ("-C" in CLI_CASES[name])


def test_aligner_refuses_genomes_past_2_30(golden_inputs):
    """2*G+1 must fit int32, as the locus ids pos*2+strand are int32: a
    genome of 2^30 bases is refused before any device table is built."""
    g, both, _ = golden_inputs
    big = np.broadcast_to(np.uint8(0), (2 ** 30,))
    idx = both.idx
    huge = SfxIndex(Genome(list(g.names), g.starts, g.lengths, big),
                    idx.lut_k, idx.sa_clean, idx.lut)
    al = pk.KAligner(huge, batch_size=8, micro_indel=20, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        al.align_batch(np.zeros((8, 100), np.uint8))
    assert al._fast_dev == {}
