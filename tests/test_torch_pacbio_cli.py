"""The port's PacBio subcommands (`pbfilter`, `ecreads`, `pbassemb`,
`eccontigs`) against `python -m kit4b_tpu`'s: the same argv on the same
seeded reads writes the same FASTA bytes, with `--device cpu` on the port.
Without CUDA, each command under its default `--device cuda` fails with
the DeviceUnavailable message and writes nothing.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.utils import runtime as jax_runtime
from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.tools.make_pacbio_golden import mutate

RUNS = {
    "pbfilter": ["pbfilter", "-i", "{d}/raw.fa", "-o", "{o}/filt.fa", "-l",
                 "150", "-t", "5"],
    "ecreads": ["ecreads", "-i", "{d}/raw.fa", "-o", "{o}/ec.fa", "-l",
                "300", "-L", "200", "-b", "256"],
    "pbassemb": ["pbassemb", "-i", "{d}/tiles.fa", "-o", "{o}/contigs.fa",
                 "-l", "300", "-p", "0.95"],
    "eccontigs": ["eccontigs", "-i", "{d}/dirty.fa", "-r", "{d}/tiles.fa",
                  "-o", "{o}/polished.fa"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """raw.fa: ten 600 bp reads of a 2 kbp genome (2 % substitutions, 8 %
    InDels), a 300 bp arm folded on its reverse complement and a 100 bp
    read; tiles.fa: 700 bp reads every 250 bp of another 2.2 kbp genome;
    dirty.fa: that genome with 12 substitutions."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    d = tmp_path_factory.mktemp("pacbio_cli")
    rng = np.random.default_rng(812)
    ref = rng.integers(0, 4, 2_000).astype(np.uint8)
    raw = [SeqRecord(f"r{i}", "", mutate(rng, ref[s:s + 600], 0.02, 0.08))
           for i, s in enumerate(rng.integers(0, 1_400, 10))]
    arm = rng.integers(0, 4, 300).astype(np.uint8)
    raw.append(SeqRecord("hp", "", np.concatenate([arm, dna.revcomp(arm)])))
    raw.append(SeqRecord("short", "", rng.integers(0, 4, 100)
                         .astype(np.uint8)))
    write_fasta(d / "raw.fa", raw)
    g = rng.integers(0, 4, 2_200).astype(np.uint8)
    write_fasta(d / "tiles.fa", [SeqRecord(f"t{i}", "", g[s:s + 700])
                                 for i, s in enumerate(range(0, 1_501, 250))])
    dirty = g.copy()
    pos = rng.choice(2_100, 12, replace=False) + 50
    dirty[pos] = (dirty[pos] + 1) % 4
    write_fasta(d / "dirty.fa", [SeqRecord("ctg", "", dirty)])
    return d


def _argv(name, d, o):
    return [a.format(d=d, o=o) for a in RUNS[name]]


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_writes_the_jax_packages_bytes(inputs, tmp_path, monkeypatch,
                                           name):
    # the JAX CLI would point JAX's compile cache at the user's home
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda: None)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        outs = {}
        for pkg, main, extra in (("jax", jax_main, []),
                                 ("port", port_main, ["--device", "cpu"])):
            o = tmp_path / pkg
            o.mkdir()
            assert main(_argv(name, inputs, o) + extra) == 0
            outs[pkg] = {p.name: p.read_bytes() for p in o.iterdir()}
    finally:
        torch.set_num_threads(n)
    assert outs["port"] == outs["jax"]
    text = next(iter(outs["port"].values())).decode()
    assert text.count(">") >= {"pbfilter": 11, "ecreads": 8, "pbassemb": 1,
                               "eccontigs": 1}[name]


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_without_cuda_refuses(inputs, tmp_path, capsys, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_main(_argv(name, inputs, tmp_path)) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
