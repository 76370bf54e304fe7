"""The port's `blitz`, `hrdx`, `kmerdist`, `benchmark`, `alignsbs`, `ngsqc`,
`maploci` and `rnade` commands against `python -m kit4b_tpu`'s: the same
argv on the golden's seeded inputs (`make_longtail_golden.write_inputs`)
with flags the golden does not use writes the same files and prints the
same text, with `--device cpu` on the port's blitz and alignsbs. Without
CUDA, blitz (gapped or not) and alignsbs under their default `--device
cuda` fail with the DeviceUnavailable message and write nothing.
"""
import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.utils import runtime as jax_runtime
from kit4b_tpu_torch import native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import SeqRecord, read_seqs, write_fasta
from kit4b_tpu_torch.tools import make_longtail_golden as mg

RUNS = {
    "blitz_gapped_opts": ["blitz", "-i", "{d}/few.fa", "-I", "{d}/s.kix",
                          "-o", "{o}/o.psl", "-c", "2", "-b", "6", "-m",
                          "400"],
    "blitz_ungapped_stride": ["blitz", "--no-gapped", "-i", "{d}/small_q.fa",
                              "{d}/few.fa", "-I", "{d}/s.kix", "-o",
                              "{o}/o.psl", "-s", "9", "-m", "20"],
    "hrdx_short": ["hrdx", "-i", "{d}/diploid.fa", "{d}/few.fa", "-o",
                   "{o}/r.fa", "-L", "50", "-z", "5"],
    "kmerdist_gz": ["kmerdist", "-i", "{d}/hits.maf.gz", "-o", "{o}/k.csv",
                    "-K", "24"],
    "bench_m4_t1": ["benchmark", "-m", "4", "-i", "{d}/truth.sam", "-t",
                    "1", "-o", "{o}/b.json"],
    "bench_m0_fa": ["benchmark", "-m", "0", "-i", "{d}/few.fa", "-o",
                    "{o}/lim.fa", "--maxreads", "3"],
    "bench_m1_few": ["benchmark", "-m", "1", "-i", "{d}/ctrl.sam",
                     "--refgenome", "{d}/bench_g.fa", "--cigarsfile",
                     "{o}/obs.csv", "--maxreads", "9"],
    "alignsbs_subs": ["alignsbs", "-p", "{d}/sbs_q.fa", "-P",
                      "{d}/sbs_asm.fa", "-i", "{d}/sbs_t.fa", "-I",
                      "{d}/sbs_asm.fa", "-b", "1", "-r", "12", "-s", "5",
                      "-o", "{o}/q.csv", "-O", "{o}/t.csv"],
    "ngsqc_k6": ["ngsqc", "-i", "{d}/qc.fq", "-o", "{o}/qc", "-K", "6",
                 "-H", "-", "-z", "0", "-Z", "20"],
    "ngsqc_plain": ["ngsqc", "-i", "{d}/raw.fq", "-o", "{o}/raw"],
    "maploci_genes": ["maploci", "-i", "{d}/de_e.sam", "-b",
                      "{d}/genes.bed", "-o", "{o}/m.csv"],
    "rnade_cds": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam",
                  "-g", "{d}/genes.bed", "-o", "{o}/de.csv", "-r", "3",
                  "-S", "2", "-a", "0", "-C", "2", "--minstartloci", "2"],
    "rnade_utr": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam",
                  "-g", "{d}/genes.bed", "-o", "{o}/de.csv", "-O",
                  "{o}/bins.csv", "-r", "4", "-n", "-2", "-L", "600"],
    "rnade_5utr": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam",
                   "-g", "{d}/genes.bed", "-o", "{o}/de.csv", "-r", "5",
                   "-b", "3", "-s", "2"],
    "rnade_3utr": ["rnade", "-i", "{d}/de_c.sam", "-I", "{d}/de_e.sam",
                   "-g", "{d}/genes.bed", "-o", "{o}/de.csv", "-r", "6"],
}
DEVICE_CMDS = ("blitz", "alignsbs")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The golden's small inputs, a blitz index built by the port, three
    queries of the small set and a gzip MAF of the golden's gapped PSL."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    d = tmp_path_factory.mktemp("longtail_cli")
    work = mg.workload()
    mg.write_inputs(work, d, big=False)
    assert port_main(["index", "-i", str(d / "blitz_g.fa"), "-o",
                      str(d / "s.kix")]) == 0
    small = dict(work["small"])
    write_fasta(d / "few.fa", [SeqRecord(n, "", small[n])
                               for n in ("gq30", "both", "len2049")])
    with np.load(mg.GOLDEN) as z:
        psl = bytes(z["cli:blitz_small_gapped:small_gapped.psl"]).decode()
    maf = mg.maf_text(psl, {"cA": work["blitz_genome"]}, small)
    (d / "hits.maf.gz").write_bytes(gzip.compress(maf.encode(), mtime=0))
    return d


def _argv(name, d, o):
    return [a.format(d=d, o=o) for a in RUNS[name]]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_writes_the_jax_packages_bytes(inputs, tmp_path, monkeypatch,
                                           name):
    # the JAX CLI would point JAX's compile cache at the user's home
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda: None)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        outs = {}
        for pkg, main in (("jax", jax_main), ("port", port_main)):
            o = tmp_path / pkg
            o.mkdir()
            extra = ["--device", "cpu"] if pkg == "port" and \
                RUNS[name][0] in DEVICE_CMDS else []
            rc, printed = _run(main, _argv(name, inputs, o) + extra)
            assert rc == 0
            outs[pkg] = ({p.name: p.read_bytes() for p in o.iterdir()},
                         printed)
    finally:
        torch.set_num_threads(n)
    assert outs["port"] == outs["jax"]
    files, printed = outs["port"]
    assert files and all(len(b) > 20 for b in files.values())
    if RUNS[name][0] == "ngsqc":
        assert printed.startswith("{") and len(files) >= 5


def test_ngsqc_plots_like_the_jax_package(inputs, tmp_path):
    pytest.importorskip("matplotlib")
    names = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        o = tmp_path / pkg
        o.mkdir()
        rc, _ = _run(main, ["ngsqc", "-i", str(inputs / "qc.fq"), "-o",
                            str(o / "qc"), "--plots"])
        assert rc == 0
        names[pkg] = sorted(p.name for p in o.iterdir())
    assert names["port"] == names["jax"]
    assert sum(n.endswith(".png") for n in names["port"]) == 4


def test_reduced_contigs_are_whole_records(inputs, tmp_path):
    assert port_main(_argv("hrdx_short", inputs, tmp_path)) == 0
    names = {r.name for r in read_seqs(tmp_path / "r.fa")}
    assert {"u0", "u1", "u2", "both"} <= names and "tiny" in names


@pytest.mark.parametrize("name", ["blitz_gapped_opts",
                                  "blitz_ungapped_stride", "alignsbs_subs"])
def test_cli_without_cuda_refuses(inputs, tmp_path, capsys, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_main(_argv(name, inputs, tmp_path)) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
