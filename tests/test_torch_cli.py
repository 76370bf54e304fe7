"""`python -m kit4b_tpu_torch hammings` against `python -m kit4b_tpu
hammings` on a small FASTA: identical output files in every mode (1
compute, also on the multi-device engines `-M` and `-R`, 3 merge, 4 trans
to .hmg, 5 trans to CSV; restricted mode `-r` is in
tests/test_torch_hammings_restricted.py), a clear failure
without CUDA, and no jax in the port's process, also through `simreads`
and paired-end `kalign` with kit4b_tpu and jax blocked (their outputs
against the JAX package's are in tests/test_torch_pe_sam.py)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.cli import main as port_main

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fasta(tmp_path):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, 400).astype(np.uint8)
    b = rng.integers(0, 4, 300).astype(np.uint8)
    b[100:140] = a[50:90]           # a repeat across chromosomes
    b[120] = (b[120] + 1) % 4
    a[300:305] = 4                  # N bases
    fa = tmp_path / "g.fa"
    write_fasta(fa, [SeqRecord("cA", "", a), SeqRecord("cB", "", b)])
    return fa


def _both(tmp_path, name, *args):
    """Runs the same hammings command through both CLIs; returns the two
    output paths."""
    outs = []
    for tag, main, extra in (("port", port_main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
        out = tmp_path / f"{tag}_{name}"
        argv = ["hammings", *[str(a).replace("{tag}", tag) for a in args],
                "-o", str(out)]
        if "-m3" not in args and "-m4" not in args and "-m5" not in args:
            argv += extra
        assert main(argv) == 0, (tag, argv)
        outs.append(out)
    return outs


@pytest.mark.parametrize("out,flags", [("all.hmg", []), ("all.csv", []),
                                       ("all.npy", []), ("sense.hmg", ["-y"])])
def test_compute_mode_matches_jax(tmp_path, fasta, out, flags):
    port, jax = _both(tmp_path, out, "-m1", "-i", fasta, "-K", "9", *flags)
    assert port.read_bytes() == jax.read_bytes()


def test_nodes_merge_and_trans_match_jax(tmp_path, fasta):
    for node in (1, 2, 3):
        port, jax = _both(tmp_path, f"n{node}.hmg", "-i", fasta, "-K", "13",
                          "-N", node, "-n", "3")
        assert port.read_bytes() == jax.read_bytes()
    port, jax = _both(tmp_path, "merged.hmg", "-m3", "-i",
                      *(tmp_path / f"{{tag}}_n{i}.hmg" for i in (1, 2, 3)))
    assert port.read_bytes() == jax.read_bytes()
    single, _ = _both(tmp_path, "single.hmg", "-i", fasta, "-K", "13")
    assert port.read_bytes() == single.read_bytes()
    port, jax = _both(tmp_path, "merged.csv", "-m5", "-i",
                      tmp_path / "{tag}_merged.hmg")
    assert port.read_bytes() == jax.read_bytes()
    port, jax = _both(tmp_path, "back.hmg", "-m4", "-i",
                      tmp_path / "{tag}_merged.csv")
    assert port.read_bytes() == jax.read_bytes()


def test_summaries_db_records_the_run(tmp_path, fasta):
    import sqlite3
    db = tmp_path / "runs.db"
    assert port_main(["hammings", "-i", str(fasta), "-o",
                      str(tmp_path / "x.npy"), "-K", "9", "--device", "cpu",
                      "-q", str(db), "-w", "smoke"]) == 0
    con = sqlite3.connect(db)
    try:
        assert con.execute("select ExprName from TblExprs").fetchall() \
            == [("smoke",)]
        assert ("device", "cpu") in con.execute(
            "select ParamName, ParamValue from TblParams").fetchall()
        assert con.execute("select ResultName from TblResults").fetchall() \
            == [("wall_seconds",)]
        assert con.execute("select ExitCode from TblProcessing").fetchall() \
            == [(0,)]
    finally:
        con.close()


def test_without_cuda_fails_with_a_clear_message(tmp_path, fasta, capsys,
                                                 monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = port_main(["hammings", "-i", str(fasta), "-o",
                    str(tmp_path / "x.hmg"), "-K", "9"])
    assert rc != 0
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err
    assert not (tmp_path / "x.hmg").exists()


@pytest.mark.parametrize("out,flags", [("all.hmg", []), ("all.csv", []),
                                       ("all.npy", []), ("sense.hmg", ["-y"]),
                                       ("k13.hmg", ["-K", "13", "-n", "1"])])
@pytest.mark.parametrize("engine", ["-M", "-R"])
def test_multi_device_engines_match_jax(tmp_path, fasta, engine, out, flags):
    """`-M` and `-R`: JAX's CLI spreads the genome over its 8 virtual CPU
    devices, the port's over the one CPU device; over every node's spans
    the answers agree byte for byte, and equal the plain engine's."""
    port, jax = _both(tmp_path, out, "-i", fasta, "-K", "9", engine, *flags)
    assert port.read_bytes() == jax.read_bytes()
    plain, _ = _both(tmp_path, "plain_" + out, "-i", fasta, "-K", "9",
                     *flags)
    assert port.read_bytes() == plain.read_bytes()


@pytest.mark.parametrize("engine", ["-M", "-R"])
def test_restricted_mode_takes_precedence(tmp_path, fasta, engine):
    port, jax = _both(tmp_path, "r.hmg", "-i", fasta, "-K", "9", "-r", "2",
                      engine)
    assert port.read_bytes() == jax.read_bytes()
    alone, _ = _both(tmp_path, "alone.hmg", "-i", fasta, "-K", "9", "-r",
                     "2")
    assert port.read_bytes() == alone.read_bytes()


def test_the_port_never_loads_jax(tmp_path):
    code = f"""
import sys
import numpy as np
import kit4b_tpu_torch
import kit4b_tpu_torch.cli
import kit4b_tpu_torch.kernels.minmm as minmm
from kit4b_tpu.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.kmer import hammings
g = np.random.default_rng(0).integers(0, 4, 200).astype(np.uint8)
write_fasta({str(tmp_path / 'g.fa')!r}, [SeqRecord("c", "", g)])
rc = kit4b_tpu_torch.cli.main(["hammings", "-i", {str(tmp_path / 'g.fa')!r},
    "-o", {str(tmp_path / 'g.npy')!r}, "-K", "9", "--device", "cpu"])
assert rc == 0
seq = np.append(g, 15).astype(np.uint8)
assert (np.load({str(tmp_path / 'g.npy')!r}) == hammings.hammings_oracle(seq, 9)).all()
assert minmm.minmm.launches == 0
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not jax, jax
print("no jax")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("no jax")


def test_simreads_and_pe_kalign_run_with_the_jax_package_blocked(tmp_path):
    try:
        from kit4b_tpu_torch import native
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    fa, kix, sam = (tmp_path / n for n in ("g.fa", "g.kix", "o.sam"))
    r1, r2 = tmp_path / "r1.fa", tmp_path / "r2.fa"
    code = f"""
import sys
sys.modules["kit4b_tpu"] = None
sys.modules["jax"] = None
import numpy as np
from kit4b_tpu_torch import cli
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
g = np.random.default_rng(3).integers(0, 4, 30_000).astype(np.uint8)
write_fasta({str(fa)!r}, [SeqRecord("c", "", g)])
assert cli.main(["index", "-i", {str(fa)!r}, "-o", {str(kix)!r}]) == 0
assert cli.main(["simreads", "-i", {str(fa)!r}, "-o", {str(r1)!r}, "-O",
                 {str(r2)!r}, "-p", "-n", "100", "-S", "2"]) == 0
assert cli.main(["kalign", "-i", {str(r1)!r}, "-I", {str(kix)!r}, "-o",
                 {str(sam)!r}, "-u", {str(r2)!r}, "-d", "150", "-D", "550",
                 "-b", "128", "--device", "cpu"]) == 0
jax = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                          "kit4b_tpu")
             and sys.modules[m] is not None)
assert not jax, jax
print("no jax")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("no jax")
    body = [ln.split("\t") for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 200 and all(int(c[1]) & 2 for c in body)
