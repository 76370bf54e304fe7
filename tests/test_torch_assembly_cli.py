"""The port's CLI subcommands of config #5 and of the float device uses
(`filter`, `assemb`, `scaffold`, `pescaffold`, `mergeoverlaps`, `rnaexpr`,
`genmlds`, `sarscov2ml`) against `python -m kit4b_tpu`'s: the same argv
on the same seeded inputs writes the same bytes (`rnaexpr`'s numeric
fields within `make_assembly_golden.R_TOL`: float32 rounding, see
tests/test_torch_rnaexpr_mlds.py). Without CUDA, the commands that would
touch the device under their default `--device cuda` fail with the
DeviceUnavailable message, and `filter` without -D runs, touching none.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu import dna
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu_torch import native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta, write_fastq
from kit4b_tpu_torch.tools import make_assembly_golden as mg

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs: 4 kbp, 400 pairs of 2 x 80 (inserts 110-300, a
    tenth duplicated, a few with one substitution, qualities), contigs
    [0, 2000) and revcomp [2020, 4000), and the CSVs of the golden's
    workload."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    d = tmp_path_factory.mktemp("asm_cli")
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 4_000).astype(np.uint8)
    a, b = [], []
    for i in range(400):
        ins = int(rng.integers(110, 301))
        p = int(rng.integers(0, len(g) - ins))
        r1 = g[p:p + 80].copy()
        if i % 17 == 0:
            r1[int(rng.integers(0, 80))] ^= 1
        a.append(r1)
        b.append(dna.revcomp(g[p + ins - 80:p + ins]))
    for i in rng.choice(400, 40):
        a.append(a[i].copy())
        b.append(b[i].copy())
    q = [rng.integers(2, 41, 80).astype(np.uint8) for _ in range(2 * len(a))]
    for m, reads in ((1, a), (2, b)):
        off = (m - 1) * len(a)
        recs = [SeqRecord(f"p{j}", "", x, q[off + j])
                for j, x in enumerate(reads)]
        write_fastq(d / f"r{m}.fq", recs)
        write_fasta(d / f"r{m}.fa", [SeqRecord(r.name, "", r.codes)
                                     for r in recs])
    write_fasta(d / "ctg.fa", [SeqRecord("ctgA", "", g[:2_000]),
                               SeqRecord("ctgB", "", dna.revcomp(
                                   g[2_020:]))])
    *_, counts, part, labels, mat = mg.workload()
    for name, text in (("counts.csv", counts), ("part.csv", part),
                       ("labels.csv", labels), ("mat.csv", mat)):
        (d / name).write_text(text)
    kix = d / "ctg.kix"
    assert port_main(["index", "-i", str(d / "ctg.fa"), "-o", str(kix)]) == 0
    for m in "12":
        assert port_main(["kalign", "-i", str(d / f"r{m}.fa"), "-I", str(kix),
                          "-o", str(d / f"m{m}.sam"), "--device",
                          "cpu"]) == 0
    return d


RUNS = {
    "filter": ["filter", "-i", "r1.fa", "-u", "r2.fa", "-o", "OUT"],
    "filter -D -k": ["filter", "-i", "r1.fa", "-u", "r2.fa", "-o", "OUT",
                     "-D", "2", "-k", "CK"],
    "filter -d -c": ["filter", "-i", "r1.fq", "-o", "OUT", "-d", "-c", "2",
                     "-Q", "3", "-x", "2", "-X", "3"],
    "assemb": ["assemb", "-i", "r1.fa", "r2.fa", "-o", "OUT", "-y", "40",
               "-Y", "25"],
    "assemb -u": ["assemb", "-i", "r1.fa", "-u", "r2.fa", "-o", "OUT", "-y",
                  "40", "-Y", "25"],
    "scaffold": ["scaffold", "-a", "r1.fa", "-A", "r2.fa", "-c", "ctg.fa",
                 "-o", "OUT", "-p", "200", "-L", "3"],
    "pescaffold": ["pescaffold", "-a", "m1.sam", "-A", "m2.sam", "-c",
                   "ctg.fa", "-o", "OUT", "-g", "30"],
    "mergeoverlaps": ["mergeoverlaps", "-i", "r1.fq", "-u", "r2.fq", "-o",
                      "OUT", "-y", "12"],
    "rnaexpr": ["rnaexpr", "-i", "counts.csv", "-c", "part.csv", "-o",
                "OUT"],
    "genmlds": ["genmlds", "-i", "counts.csv", "-l", "labels.csv", "-o",
                "OUT"],
    "sarscov2ml": ["sarscov2ml", "-i", "mat.csv", "-o", "OUT", "-l", "3",
                   "-r", "20"],
}


def _argv(argv, d, out, ck):
    names = ("r1.fa", "r2.fa", "r1.fq", "r2.fq", "ctg.fa", "m1.sam",
             "m2.sam", "counts.csv", "part.csv", "labels.csv", "mat.csv")
    return [str(out) if a == "OUT" else str(ck) if a == "CK"
            else str(d / a) if a in names else a for a in argv]


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_bytes_equal_jax(inputs, tmp_path, run):
    argv = RUNS[run]
    outs = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        out, ck = tmp_path / f"{pkg}.out", tmp_path / f"{pkg}.ck"
        full = _argv(argv, inputs, out, ck)
        if argv[0] in mg.DEVICE_CMDS and pkg == "port":
            full += ["--device", "cpu"]
        assert main(full) == 0
        if "-k" in argv:           # the run again resumes from the store
            out.rename(tmp_path / f"{pkg}.first")
            assert main(full) == 0
            assert out.read_bytes() == (tmp_path / f"{pkg}.first").read_bytes()
        outs[pkg] = out.read_bytes()
    assert outs["port"].count(b"\n") > 2
    if run == "rnaexpr":
        assert mg.rnaexpr_close(outs["port"].decode(), outs["jax"].decode(),
                                400)
    else:
        assert outs["port"] == outs["jax"]
    if run == "scaffold":
        assert b"contigs=ctgA,ctgB" in outs["port"]


@pytest.mark.parametrize("run", ["filter -D -k", "scaffold", "rnaexpr",
                                 "sarscov2ml"])
def test_device_commands_without_cuda_fail(inputs, tmp_path, capsys,
                                           monkeypatch, run):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.out"
    rc = port_main(_argv(RUNS[run], inputs, out, tmp_path / "ck"))
    assert rc == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err
    assert not out.exists()


def test_filter_without_neardup_touches_no_device(inputs, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "f.fa"
    assert port_main(_argv(RUNS["filter"], inputs, out, None)) == 0
    assert out.stat().st_size > 0


def test_simreads_mates_link_nothing_in_either_package(inputs, tmp_path):
    """`simreads -p` names each mate by its own locus, and both packages'
    scaffolders pair mates by name: its pairs link no contigs (ROADMAP.md
    queue C). Under shared names the same reads join the two contigs."""
    from kit4b_tpu_torch.io.fasta import Genome
    from kit4b_tpu_torch.sim import simreads
    rng = np.random.default_rng(41)
    g = rng.integers(0, 4, 4_000).astype(np.uint8)
    r1, r2 = simreads.sim_reads(
        Genome.from_records([SeqRecord("g", "", g)]),
        simreads.SimParams(n_reads=400, read_len=80, pe=True,
                           pe_insert_min=200, pe_insert_max=300, seed=4))
    assert all(a.name != b.name for a, b in zip(r1, r2))
    write_fasta(tmp_path / "c.fa", [SeqRecord("c1", "", g[:2_000]),
                                    SeqRecord("c2", "", g[2_020:])])
    outs = {}
    for names in ("simreads", "shared"):
        for m, recs in (("1", r1), ("2", r2)):
            write_fasta(tmp_path / f"r{m}.fa", [
                SeqRecord(r.name if names == "simreads" else f"p{j}", "",
                          r.codes) for j, r in enumerate(recs)])
        for pkg, main in (("jax", jax_main), ("port", port_main)):
            argv = ["scaffold", "-a", str(tmp_path / "r1.fa"), "-A",
                    str(tmp_path / "r2.fa"), "-c", str(tmp_path / "c.fa"),
                    "-o", str(tmp_path / "s.fa"), "-p", "250"]
            assert main(argv + (["--device", "cpu"] if pkg == "port"
                                else [])) == 0
            outs[names, pkg] = (tmp_path / "s.fa").read_bytes()
        assert outs[names, "port"] == outs[names, "jax"]
    assert b"contigs=c1,c2" not in outs["simreads", "port"]
    assert b"contigs=c1,c2" in outs["shared", "port"]
