"""kalign's SNP side outputs in the port against the JAX package, bit for
bit: the coverage WIG (io.wig), the Packed Base Alleles (kmer.pba,
`pba_from_counts`, `save_pba`/`load_pba` across packages), the marker
FASTA (`report_markers`, which also numbers the calls the SNP CSV
reports), the centroid contexts (`snp_centroids`, its CSV) and the
DiSNP/TriSNP pass over the written SAM (`call_multisnps`,
`write_multisnps_csv`), all on one pileup of the options golden's SNP
reads (12 SNPs, two heterozygous, 20x over 3 kbp); then the `genpba`
subcommand (`python -m kit4b_tpu_torch genpba --device cpu` against
`python -m kit4b_tpu genpba`), and its -y/-l refusal where the JAX
package's genpba fails."""
import copy

import numpy as np
import pytest

from kit4b_tpu.align import snp as jsnp
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.io.fasta import Genome as JGenome
from kit4b_tpu.io.wig import write_wig as jwig
from kit4b_tpu.kmer import pba as jpba
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.align import snp as psnp
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.io.wig import write_wig as pwig
from kit4b_tpu_torch.kmer import pba as ppba
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def pileup(tmp_path_factory):
    """(port genome, JAX genome, SAM path, port caller, JAX caller with the
    same counts): the options workload's reads aligned by the port and
    written with the pileup attached."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    g, se, _, _, _, _ = mg.workload()
    idx = SfxIndex.build(g)
    sam = tmp_path_factory.mktemp("snp") / "out.sam"
    caller = psnp.SnpCaller(g, psnp.SnpOptions(min_snp_reads=5))
    pk.write_sam_fast(sam, idx, pk.KAligner(idx, batch_size=256,
                                            device="cpu"),
                      se, cmdline="s", emit_unmapped=True,
                      snp_caller=caller)
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    jcaller = jsnp.SnpCaller(jg, jsnp.SnpOptions(min_snp_reads=5))
    jcaller._counts[:] = caller._counts
    return g, jg, sam, caller, jcaller


def test_calls_match(pileup):
    *_, caller, jcaller = pileup
    pc, jc = caller.call(), jcaller.call()
    assert [vars(c).keys() for c in pc] == [vars(c).keys() for c in jc]
    assert len(pc) >= 10
    for a, b in zip(pc, jc):
        for k, v in vars(a).items():
            np.testing.assert_array_equal(v, getattr(b, k), err_msg=k)


def test_wig_bytes_match(tmp_path, pileup):
    g, jg, _, caller, jcaller = pileup
    jwig(tmp_path / "j.wig", jg, jcaller.coverage())
    pwig(tmp_path / "p.wig", g, caller.coverage(), )
    assert (tmp_path / "j.wig").read_bytes() == \
        (tmp_path / "p.wig").read_bytes()
    assert (tmp_path / "p.wig").read_text().count("variableStep") > 100


def test_pba_matches_and_loads_across_packages(tmp_path, pileup):
    g, jg, _, caller, jcaller = pileup
    counts = caller._counts.reshape(-1, 5)
    # every score of both coverage regimes, and zero coverage
    rng = np.random.default_rng(2)
    synth = rng.integers(0, 9, (4000, 5)).astype(np.uint32)
    synth[:100] = 0
    for c in (counts, synth):
        np.testing.assert_array_equal(jpba.pba_from_counts(c),
                                      ppba.pba_from_counts(c))
    pba = ppba.pba_from_counts(counts)
    assert len(np.unique(pba)) > 5
    jpba.save_pba(tmp_path / "j.pba.npz", jg, pba)
    ppba.save_pba(tmp_path / "p.pba.npz", g, pba)
    for f in ("j", "p"):
        for mod in (jpba, ppba):
            rs, chroms = mod.load_pba(tmp_path / f"{f}.pba.npz")
            assert rs == "readset" and list(chroms) == list(g.names)
            for i, name in enumerate(g.names):
                s = int(g.starts[i])
                np.testing.assert_array_equal(
                    chroms[name], pba[s:s + int(g.lengths[i])])


@pytest.mark.parametrize("flank,thres", [(25, 0.333), (10, 0.2), (40, 0.5)])
def test_markers_match(tmp_path, pileup, flank, thres):
    *_, caller, jcaller = pileup
    pc, jc = caller.call(), jcaller.call()
    n = psnp.report_markers(tmp_path / "p.fa", caller, pc,
                            marker5_len=flank, marker3_len=flank,
                            poly_thres=thres)
    assert jsnp.report_markers(tmp_path / "j.fa", jcaller, jc,
                               marker5_len=flank, marker3_len=flank,
                               poly_thres=thres) == n
    assert (tmp_path / "j.fa").read_bytes() == (tmp_path / "p.fa").read_bytes()
    assert [(c.marker_id, c.num_polymorphic) for c in pc] == \
        [(c.marker_id, c.num_polymorphic) for c in jc]
    # the SNP CSV reports the marker numbers
    psnp.write_snps_csv(tmp_path / "p.csv", pc)
    jsnp.write_snps_csv(tmp_path / "j.csv", jc)
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "p.csv").read_bytes()
    if flank == 25:
        assert n > 0 and any(c.marker_id == 0 for c in pc)


def test_centroids_match(tmp_path, pileup):
    *_, caller, jcaller = pileup
    pc, jc = caller.call(), jcaller.call()
    a, b = psnp.snp_centroids(caller, pc), jsnp.snp_centroids(jcaller, jc)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["num_snps"].sum() > 0
    psnp.write_snp_centroids_csv(tmp_path / "p.csv", a)
    jsnp.write_snp_centroids_csv(tmp_path / "j.csv", b)
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "p.csv").read_bytes()


@pytest.mark.parametrize("order,max_sep,min_reads",
                         [(2, 300, 1), (3, 300, 1), (2, 120, 3), (3, 700, 2)])
def test_multisnps_match(tmp_path, pileup, order, max_sep, min_reads):
    _, _, sam, caller, jcaller = pileup
    pc, jc = caller.call(), jcaller.call()
    got = psnp.call_multisnps(sam, pc, order=order, max_sep=max_sep,
                              min_reads=min_reads)
    want = jsnp.call_multisnps(sam, jc, order=order, max_sep=max_sep,
                               min_reads=min_reads)
    assert got == want and len(got) > 0
    psnp.write_multisnps_csv(tmp_path / "p.csv", got, order)
    jsnp.write_multisnps_csv(tmp_path / "j.csv", want, order)
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "p.csv").read_bytes()


def _genpba(tmp_path, flags):
    g, se, _, pairs, _, _ = mg.workload()
    fa = tmp_path / "g.fa"
    write_fasta(fa, [SeqRecord(g.names[i], "", g.chrom_codes(i))
                     for i in range(g.nchroms())])
    reads = tmp_path / "r.fa"
    write_fasta(reads, se)
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        kix = d / "g.kix"
        assert main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        argv = ["genpba", "-i", str(reads), "-I", str(kix), "-o",
                str(d / "o.pba.npz"), "-b", "256",
                *[f.replace("{d}", str(d)) for f in flags]]
        outs[tag] = (argv, extra, d)
    return outs


@pytest.mark.parametrize("flags", [["--sam", "{d}/o.sam"],
                                   ["-C", "50", "-s", "3", "-p", "3"]])
def test_genpba_matches_jax(tmp_path, pileup, flags):
    runs = _genpba(tmp_path, flags)
    got = {}
    for tag, (argv, extra, d) in runs.items():
        main = jax_main if tag == "jax" else port_main
        assert main(argv + extra) == 0
        _, chroms = ppba.load_pba(d / "o.pba.npz")
        got[tag] = ({k: v.tobytes() for k, v in chroms.items()},
                    (d / "o.sam").read_bytes() if "--sam" in flags else None)
    assert got["port"] == got["jax"]
    assert any(np.frombuffer(v, np.uint8).any()
               for v in got["port"][0].values())


@pytest.mark.parametrize("flag", [["-y", "10"], ["-l", "5000"]])
def test_genpba_refuses_where_jax_fails(tmp_path, capsys, flag):
    runs = _genpba(tmp_path, flag)
    argv, _, _ = runs["jax"]
    with pytest.raises(AttributeError, match="mlmode"):
        jax_main(argv)
    argv, extra, d = runs["port"]
    assert port_main(argv + extra) == 1
    assert "queue C" in capsys.readouterr().err
    assert not (d / "o.pba.npz").exists()


def test_snp_outputs_are_copies():
    """The port's DiSNP helper enumerates as the JAX package's does."""
    items = [3, 10, 40, 41]
    for order in (2, 3):
        assert list(psnp._combos(items, order)) == \
            list(jsnp._combos(copy.copy(items), order))
