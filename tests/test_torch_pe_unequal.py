"""Paired ends whose mates differ in length, in the port against the JAX
package: the host full-stats path (`align_batch(return_raw=True)` on each
mate list, `_pair` over both hit lists, the orphan rescue's window scan)
gives the same PePair stream in pe modes 1-4, also with the microInDel
rescue on and for pairs of equal mates whose length changes between pairs;
and the CLI `kalign -u` writes the same SAM and VCF bytes
(`python -m kit4b_tpu_torch --device cpu` against `python -m kit4b_tpu`)."""
import numpy as np
import pytest

from kit4b_tpu.align import pe as jpe
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import pe as ppe
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.sim import simreads
from kit4b_tpu_torch.tools import make_kalign_pe_golden as pg
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import Both, pair_key

BATCH = 256
MATE2_LENS = (110, 130, 150)


@pytest.fixture(scope="module")
def genome():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    g = pg.repeat_genome()
    return g, Both(g)


def _pairs(g, kind):
    """Simulated 2 x 150 pairs: "unequal", mate 2 cut to a seeded length
    in MATE2_LENS; "mixed", equal mates of 150 or 120 bp."""
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=300, read_len=150, pe=True, pe_insert_min=150,
        pe_insert_max=700, error_mode="illumina", subs_rate=0.02, seed=61))
    rng = np.random.default_rng(62)
    if kind == "unequal":
        for rec in r2:
            rec.codes = rec.codes[:rng.choice(MATE2_LENS)].copy()
        return r1, r2
    for a, b in zip(r1[::2], r2[::2]):
        a.codes, b.codes = a.codes[:120].copy(), b.codes[:120].copy()
    return r1, r2


CASES = [("unequal", m, {}) for m in (1, 2, 3, 4)] + [
    ("mixed", 1, {}), ("unequal", 3, dict(micro_indel=20))]


@pytest.mark.parametrize("kind,mode,kw", CASES)
def test_align_pairs_matches_jax(genome, kind, mode, kw):
    g, both = genome
    r1, r2 = _pairs(g, kind)
    ja, pa = both.aligners(BATCH, **kw)
    outs = []
    for mod, al in ((jpe, ja), (ppe, pa)):
        pal = mod.PeAligner(al, pair_min_len=pg.MIN_INS,
                            pair_max_len=pg.MAX_INS, pe_mode=mode)
        outs.append([(a.name, b.name, pair_key(pp))
                     for a, b, pp in pal.align_pairs(r1, r2)])
    assert outs[1] == outs[0]
    nar = [k[2][0] for k in outs[1]]
    assert 0.5 * len(nar) < nar.count("accepted") < len(nar)
    if mode in (3, 4):   # orphans fall back to single-end acceptance
        assert any(k[2][0] == "nopair" and (k[2][1] or k[2][2])
                   for k in outs[1])


@pytest.mark.parametrize("mode,flags", [("1", ["-M", "1"]),
                                        ("3", ["-S", "{d}/snps.vcf",
                                               "-p", "2"])])
def test_cli_kalign_unequal_mates_match_jax(tmp_path, genome, mode, flags):
    g, _ = genome
    r1, r2 = _pairs(g, "unequal")
    fa = tmp_path / "genome.fa"
    write_fasta(fa, [SeqRecord(n, "", g.chrom_codes(i))
                     for i, n in enumerate(g.names)])
    write_fasta(tmp_path / "r1.fa", r1)
    write_fasta(tmp_path / "r2.fa", r2)
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        kix = d / "genome.kix"
        assert main(["index", "-i", str(fa), "-o", str(kix)]) == 0
        argv = ["kalign", "-i", str(tmp_path / "r1.fa"), "-I", str(kix),
                "-o", str(d / "out.sam"), "-u", str(tmp_path / "r2.fa"),
                "-U", mode, "-d", str(pg.MIN_INS), "-D", str(pg.MAX_INS),
                "-b", str(BATCH), *[f.replace("{d}", str(d)) for f in flags]]
        assert main(argv + extra) == 0, tag
        outs[tag] = {p.name: p.read_bytes() for p in d.iterdir()
                     if p.suffix in (".sam", ".vcf")}
    assert outs["port"] == outs["jax"]
    body = [ln.split(b"\t") for ln in outs["port"]["out.sam"].splitlines()
            if not ln.startswith(b"@")]
    assert sum(int(c[1]) & 2 != 0 for c in body) > 0.5 * len(body)
    assert {len(c[9]) for c in body} >= set(MATE2_LENS)
