"""SAM from the port against SAM from the JAX package, byte for byte:
`write_sam_fast` on record streams and read files, and the
CLI end to end (`python -m kit4b_tpu_torch index` + `kalign --device cpu`
against `kit4b_tpu.cli`) on the random and repeat genomes, L 100 and 64,
reads with Ns, covering the v4 tier 1, the v5 tier 1 with its device tier
2, and the host ladder taking tier 2's leftover -3 rows."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kit4b_tpu import dna
from kit4b_tpu.align import kalign as jk
from kit4b_tpu.align.snp import SnpCaller
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.index.sfx_index import SfxIndex
from kit4b_tpu.io.fasta import Genome, SeqRecord, write_fasta, write_fastq
from kit4b_tpu.sim import simreads
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.cli import main as port_main

REPO = Path(__file__).resolve().parents[1]
G = 120_000


def _genome(kind: str) -> np.ndarray:
    """120 kbp codes: random; "repeats", 30 copies of a 400 bp unit (the
    v4 tier 1, whose tier 2 overflows to the host ladder); "copies3",
    three copies of a 4 kbp unit, whose reads overflow tier 1 with few
    seed buckets over 7 entries (the v5 tier 1 with reads in tier 2)."""
    rng = np.random.default_rng(23)
    seq = rng.integers(0, 4, G).astype(np.uint8)
    if kind == "repeats":
        unit = rng.integers(0, 4, 400).astype(np.uint8)
        for i in range(30):
            seq[1000 + i * 3500:1400 + i * 3500] = unit
    elif kind == "copies3":
        for i in (1, 2):
            seq[i * 30_000:i * 30_000 + 4000] = seq[:4000]
    seq[5000:5060] = dna.BASE_N
    return seq


def _reads(seq, L, n, seed, n_rate):
    g = Genome(["chr1"], np.array([0]), np.array([G]),
               np.append(seq, dna.BASE_EOG).astype(np.uint8))
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=n, read_len=L, seed=seed, error_mode="illumina",
        subs_rate=0.03))
    mask = np.random.default_rng(seed).random((len(recs), L)) < n_rate
    for rec, row in zip(recs, mask):
        rec.codes = np.where(row, dna.BASE_N, rec.codes).astype(np.uint8)
    rng = np.random.default_rng(seed + 1)
    recs.append(SeqRecord("junk", "", rng.integers(0, 4, L)
                          .astype(np.uint8)))                   # nohit
    many_n = recs[0].codes.copy()
    many_n[5:L - 5] = dna.BASE_N
    recs.append(SeqRecord("enns", "", many_n))                  # excess Ns
    return g, recs


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def repeats(lib):
    g, recs = _reads(_genome("repeats"), 100, 400, 77, 0.002)
    rng = np.random.default_rng(9)
    for r in recs[::3]:
        r.qual = rng.integers(2, 40, len(r.codes)).astype(np.uint8)
    return SfxIndex.build(g), recs


@pytest.mark.parametrize("unmapped", [True, False])
def test_write_sam_fast_records_match_jax(tmp_path, repeats, unmapped):
    idx, recs = repeats
    sc = [SnpCaller(idx.genome), SnpCaller(idx.genome)]
    outs = []
    for mod, kw, caller in ((jk, {}, sc[0]), (pk, {"device": "cpu"}, sc[1])):
        sam, csv = tmp_path / f"{mod.__name__}.sam", tmp_path / "s.csv"
        st = mod.write_sam_fast(sam, idx, mod.KAligner(idx, batch_size=128,
                                                       **kw),
                                recs, cmdline="x y", emit_unmapped=unmapped,
                                snp_caller=caller, stats_path=csv)
        outs.append((dict(st), sam.read_bytes(), csv.read_bytes()))
    assert outs[0] == outs[1]
    assert tuple(outs[1][0]) == pk.NAR_NAMES
    assert outs[0][0]["multi"] > 0 and outs[0][0]["ns"] > 0
    np.testing.assert_array_equal(sc[0]._counts, sc[1]._counts)


@pytest.mark.parametrize("fmt,mixed", [("fasta", False), ("fastq", False),
                                       ("fastq", True)])
def test_write_sam_fast_path_source_matches_jax(tmp_path, repeats, fmt,
                                                mixed):
    idx, recs = repeats
    if mixed:   # mixed read lengths leave the block route for records
        recs = recs[:150] + [SeqRecord("short", "", recs[0].codes[:80])] \
            + recs[150:]
    src = tmp_path / f"reads.{fmt}"
    (write_fasta if fmt == "fasta" else write_fastq)(src, recs)
    sams = []
    for mod, kw in ((jk, {}), (pk, {"device": "cpu"})):
        sam = tmp_path / f"{mod.__name__}.sam"
        mod.write_sam_fast(sam, idx, mod.KAligner(idx, batch_size=128, **kw),
                           str(src), cmdline="c")
        sams.append(sam.read_bytes())
    assert sams[0] == sams[1]


def test_write_sam_fast_refuses_bam(tmp_path, repeats):
    idx, recs = repeats
    with pytest.raises(NotImplementedError, match="item 20"):
        pk.write_sam_fast(tmp_path / "o.bam", idx,
                          pk.KAligner(idx, device="cpu"), recs)
    assert not (tmp_path / "o.bam").exists()


CLI_CASES = {   # kind, read length, reads, batch, N rate, format, flags
    "random-100": ("random", 100, 1500, 1024, 0.002, "fasta",
                   ["-M", "1", "-O", "{tmp}/stats.csv"]),
    "random-64": ("random", 64, 1200, 1024, 0.0, "fastq",
                  ["-s", "3", "-r", "2", "-n", "2", "-R", "3", "-m", "1"]),
    # ~10 % of reads in the repeat: > 128 escalations a batch of 2048
    "repeats-64": ("repeats", 64, 2100, 2048, 0.002, "fasta",
                   ["-S", "{tmp}/snps.csv", "-M", "1"]),
    "copies3-100": ("copies3", 100, 1000, 1024, 0.002, "fasta", ["-M", "1"]),
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_index_kalign_match_jax(tmp_path, lib, name):
    kind, L, n, batch, n_rate, fmt, flags = CLI_CASES[name]
    seq = _genome(kind)
    fa = tmp_path / "genome.fa"
    write_fasta(fa, [SeqRecord("chr1", "", seq)])
    g, recs = _reads(seq, L, n, 7 + L, n_rate)
    reads = tmp_path / f"reads.{fmt}"
    (write_fasta if fmt == "fasta" else write_fastq)(reads, recs)
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        kix = d / "genome.kix"
        assert main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        argv = ["kalign", "-i", str(reads), "-I", str(kix), "-o",
                str(d / "out.sam"), "-b", str(batch),
                *[f.replace("{tmp}", str(d)) for f in flags]]
        assert main(argv + extra) == 0, tag
        outs[tag] = {p.name: p.read_bytes() for p in d.iterdir()
                     if p.suffix in (".sam", ".csv")}
        idx = SfxIndex.load(kix)
        outs[tag]["index"] = [idx.lut_k, idx.genome.seq.tobytes(),
                              idx.sa_clean.tobytes(), idx.lut.tobytes(),
                              idx.genome.names]
    assert outs["port"] == outs["jax"]
    assert len(outs["port"]) == 2 + ("-O" in flags or "-S" in flags)

    # the path this case covers, on the port's aligner: -3 rows of the
    # first batch's tier 1 alone, and left after tier 2 for the ladder
    first = np.stack([r.codes for r in recs[:batch]])
    al = pk.KAligner(idx, batch_size=batch, device="cpu")
    left = int((al._submit(first)[1][:, 0] == -3).sum())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "TIER2", None)
        mp.setattr(pk, "TIER2_V4", None)
        tier1 = int((al._submit(first)[1][:, 0] == -3).sum())
    assert al._lut4_decided == {L: kind != "repeats"}   # v5, else v4
    if kind == "repeats":
        assert left > 0          # the host ladder takes tier 2's leftovers
    if kind == "copies3":
        assert tier1 > left == 0   # device tier 2 resolved every escalation


@pytest.mark.parametrize("flag", [["-u", "{mixed}"], ["-y", "3"],
                                  ["-l", "50"], ["-C", "20"],
                                  ["--mlmode", "2"], ["--bisulfite"],
                                  ["-Z", "chr1"], ["-5", "2"],
                                  ["-B", "r.bed"]])
def test_cli_unported_flags_raise(tmp_path, capsys, request, flag):
    reads, kix = "r.fa", "g.kix"
    if flag == ["-u", "{mixed}"]:
        # paired ends whose mates differ in length: JAX pairs them on the
        # host, which the port has not ported yet (item 12)
        request.getfixturevalue("lib")
        seq = _genome("random")
        fa, kix = tmp_path / "g.fa", tmp_path / "g.kix"
        write_fasta(fa, [SeqRecord("chr1", "", seq)])
        assert port_main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        reads = tmp_path / "r1.fa"
        write_fasta(reads, [SeqRecord(f"p{i}", "", seq[i:i + 100])
                            for i in range(8)])
        write_fasta(tmp_path / "r2.fa", [SeqRecord(f"p{i}", "",
                                                   seq[i + 300:i + 390])
                                         for i in range(8)])
        flag = ["-u", str(tmp_path / "r2.fa")]
    rc = port_main(["kalign", "-i", str(reads), "-I", str(kix), "-o",
                    str(tmp_path / "o.sam"), "--device", "cpu", *flag])
    assert rc == 1
    err = capsys.readouterr().err
    assert "not ported yet: ROADMAP.md queue A item" in err
    if flag[0] == "-u":
        assert "item 12" in err and not (tmp_path / "o.sam").exists()


def test_cli_without_cuda_fails_and_port_imports_no_jax(tmp_path):
    code = ("import sys, torch\n"
            "from kit4b_tpu_torch import cli\n"
            "import kit4b_tpu_torch.align.kalign, kit4b_tpu_torch.state\n"
            "from kit4b_tpu_torch.tools import make_kalign_golden\n"
            "assert 'jax' not in sys.modules\n"
            "if not torch.cuda.is_available():\n"
            f"    rc = cli.main(['kalign', '-i', 'r.fa', '-I', 'g.kix', "
            f"'-o', {str(tmp_path / 'o.sam')!r}])\n"
            "    assert rc == 1, rc\n"
            "assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
