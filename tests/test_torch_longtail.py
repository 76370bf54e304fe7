"""The port's hrdx (assembly/hrdx.py), kmerdist (pacbio/kmerdist.py) and MAF
reader (io/maf.py) against the JAX package's on the CPU, on
tests/test_radseq_hrdx.py's and tests/test_pacbio.py's inputs and on
seeded ones: the kept contigs, their FASTA bytes and the stats of hrdx;
the parsed MAF blocks; kmerdist's counts and CSV bytes, on gap-dense MAFs
too, and equal to a direct count of the runs from a blitz PSL
(`make_longtail_golden.kmer_runs`).
"""
import dataclasses
import gzip

import numpy as np
import pytest

from kit4b_tpu.assembly import hrdx as jhr
from kit4b_tpu.io import maf as jmaf
from kit4b_tpu.io.fasta import SeqRecord as JRecord
from kit4b_tpu.pacbio import kmerdist as jkd
from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.assembly import hrdx as phr
from kit4b_tpu_torch.io import maf as pmaf
from kit4b_tpu_torch.io.fasta import SeqRecord as PRecord
from kit4b_tpu_torch.pacbio import kmerdist as pkd
from kit4b_tpu_torch.tools import make_longtail_golden as mg

TEST_PACBIO_MAF = ("##maf version=1\n"
                   "a score=10\n"
                   "s ref.chr1 0 10 + 100 ACGTACGTAC\n"
                   "s q.read1  0 10 + 50  ACGTAC-TAC\n"
                   "\n"
                   "a score=5\n"
                   "s ref.chr1 20 5 + 100 AAAAA\n"
                   "s q.read2   0 5 + 30  AAAAA\n")


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def _gappy_maf(rng, n_blocks, width, gap, n_rate, rows=2) -> str:
    """Random MAF blocks of `rows` rows: a reference row, then rows that
    copy it with substitutions, '-' at rate `gap` in either row and Ns at
    `n_rate`; a block with one row and blocks with no score attribute."""
    out = ["##maf version=1", "# a comment line", ""]
    for b in range(n_blocks):
        ref = rng.integers(0, 4, width).astype(np.uint8)
        lines = [f"a score={rng.integers(0, 500)}.5 pass=2" if b % 3
                 else "a"]
        lines.append(f"s ref.c{b} {b * 10} {width} + 10000 "
                     f"{_row(rng, ref, 0.0, gap, n_rate)}")
        for r in range(rows - 1 if b % 7 else 0):
            lines.append(f"s q{b}.{r} 0 {width} {'+-'[r % 2]} 500 "
                         f"{_row(rng, ref, 0.05, gap, n_rate)}")
        out += lines + [""]
    return "\n".join(out) + "\n"


def _row(rng, ref, sub, gap, n_rate) -> str:
    c = ref.copy()
    s = rng.random(len(c)) < sub
    c[s] = (c[s] + 1) % 4
    c[rng.random(len(c)) < n_rate] = dna.BASE_N
    c[rng.random(len(c)) < gap] = dna.BASE_INDEL
    return dna.decode(c)


def _blocks(mod, path):
    return [(b.score, [(dataclasses.asdict(s), s.codes.tolist())
                       for s in b.seqs]) for b in mod.read_maf(path)]


@pytest.mark.parametrize("gz", [False, True])
def test_read_maf_matches(tmp_path, gz):
    rng = np.random.default_rng(140)
    text = TEST_PACBIO_MAF + "\n" + _gappy_maf(rng, 12, 60, 0.2, 0.05, 3)
    path = tmp_path / ("t.maf.gz" if gz else "t.maf")
    if gz:
        path.write_bytes(gzip.compress(text.encode(), mtime=0))
    else:
        path.write_text(text)
    got = _blocks(pmaf, path)
    assert got == _blocks(jmaf, path)
    assert len(got) == 14 and got[0][1][1][1][6] == dna.BASE_INDEL


def test_kmerdist_test_pacbio_case(tmp_path):
    """tests/test_pacbio.py's MAF: the same counts and CSV, and that
    test's own checks on the port's."""
    maf = tmp_path / "t.maf"
    maf.write_text(TEST_PACBIO_MAF)
    d = pkd.kmer_dist(maf, max_k=5)
    assert d == jkd.kmer_dist(maf, max_k=5)
    assert d["blocks"] == 2
    assert d["counts"][1] == 9 + 5 and d["counts"][5] == 2 + 1
    pkd.write_kmer_dist(tmp_path / "p.csv", d)
    jkd.write_kmer_dist(tmp_path / "j.csv", d)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    assert (tmp_path / "p.csv").read_text().startswith('"K"')


@pytest.mark.parametrize("gap,n_rate,rows,max_k", [
    (0.0, 0.0, 2, 16), (0.3, 0.02, 2, 16), (0.6, 0.1, 3, 8),
    (0.9, 0.0, 2, 4), (0.05, 0.3, 4, 30)])
def test_kmerdist_on_gap_dense_mafs_matches(tmp_path, gap, n_rate, rows,
                                            max_k):
    rng = np.random.default_rng(int(gap * 100) + rows)
    maf = tmp_path / "g.maf"
    maf.write_text(_gappy_maf(rng, 20, 200, gap, n_rate, rows))
    d = pkd.kmer_dist(maf, max_k=max_k)
    assert d == jkd.kmer_dist(maf, max_k=max_k)
    assert d["blocks"] == 20 - 3        # blocks 0, 7 and 14 hold one row
    for mod, name in ((pkd, "p"), (jkd, "j")):
        mod.write_kmer_dist(tmp_path / f"{name}.csv", d)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


def test_kmerdist_of_blitz_hits_is_the_direct_count(tmp_path):
    """The golden's path: a MAF written from gapped blitz hits (the
    committed golden's small PSL) counted by kmerdist equals the runs
    counted straight from the hits' blocks and bases."""
    with np.load(mg.GOLDEN) as z:
        psl = bytes(z["cli:blitz_small_gapped:small_gapped.psl"]).decode()
    g, small = mg.blitz_small()
    genome, queries = {"cA": g}, dict(small)
    maf = tmp_path / "h.maf"
    maf.write_text(mg.maf_text(psl, genome, queries))
    d = pkd.kmer_dist(maf, max_k=16)
    assert d == mg.kmer_runs(psl, genome, queries, 16)
    assert d == jkd.kmer_dist(maf, max_k=16)
    assert d["blocks"] >= 10 and d["counts"][16] > 0


def _hrdx_both(recs, **kw):
    jk, js = jhr.reduce_homozygous(
        [JRecord(n, "", c) for n, c in recs], **kw)
    pk, ps = phr.reduce_homozygous(
        [PRecord(n, "", c) for n, c in recs], **kw)
    return (jk, js), (pk, ps)


def test_hrdx_test_radseq_case(lib):
    """tests/test_radseq_hrdx.py's contigs: the same contigs kept, and that
    test's checks on the port's."""
    rng = np.random.default_rng(11)
    hap_a = rng.integers(0, 4, 2000).astype(np.uint8)
    hap_b = hap_a.copy()
    idx = rng.choice(2000, 20, replace=False)
    hap_b[idx] = (hap_b[idx] + 1) % 4
    other = rng.integers(0, 4, 1500).astype(np.uint8)
    recs = [("ctgA", hap_a), ("ctgB", hap_b[:1600]), ("ctgC", other)]
    (jk, js), (pk, ps) = _hrdx_both(recs, max_homozy_subs=3,
                                    min_homozy_len=75)
    assert [r.name for r in pk] == [r.name for r in jk] == ["ctgA", "ctgC"]
    assert ps == js and ps["reduced"] == 1


@pytest.mark.parametrize("kw", [
    dict(), dict(max_homozy_subs=1, min_homozy_len=150, min_het_len=10),
    dict(min_ctg_len=2_500, min_reduce_cover=0.5),
    dict(max_homozy_subs=0), dict(min_ctg_len=10_000)])
def test_hrdx_diploid_set_matches(lib, tmp_path, kw):
    rng = np.random.default_rng(2024)
    recs = mg.diploid_contigs(rng, 18_000, (1_500, 5_000), 2, 2_500)
    recs.append(("tiny", rng.integers(0, 4, 60).astype(np.uint8)))
    (jk, js), (pk, ps) = _hrdx_both(recs, **kw)
    assert ps == js
    assert [(r.name, r.codes.tolist()) for r in pk] == \
        [(r.name, r.codes.tolist()) for r in jk]
    jhr.write_reduced(tmp_path / "j.fa", jk)
    phr.write_reduced(tmp_path / "p.fa", pk)
    assert (tmp_path / "p.fa").read_bytes() == \
        (tmp_path / "j.fa").read_bytes()
    if not kw:
        assert ps["reduced"] >= 3 and {"u0", "u1"} <= {r.name for r in pk}


@pytest.mark.parametrize("seed", range(6))
def test_covered_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 30))
    starts = rng.integers(0, 5_000, n)
    spans = [(int(s), int(s + rng.integers(1, 400))) for s in starts]
    for het in (0, 1, 30, 200):
        assert phr._covered(spans, 6_000, het) == \
            jhr._covered(spans, 6_000, het)
