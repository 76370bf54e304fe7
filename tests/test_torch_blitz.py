"""The port's blitz (kit4b_tpu_torch/align/blitz.py) against the JAX
package's on the CPU: the same seeded queries give the same BlitzHit
fields and PSL bytes, ungapped and gapped (the port's banded SW engine on
its plain PyTorch versions here, JAX's `lax.scan` there). The queries are
tests/test_blitz.py's and the edge cases of
`make_longtail_golden.blitz_small()` (no chain, chains on both strands, a
40 bp deletion and a 30 bp insertion, a chain past the genome's end, a
query under lut_k, 2,048 and 2,049 bp), plus queries on a genome of three
chromosomes (the chromosome found from t0, a refinement window cut at a
chromosome's end). The gapped queries stay at most about 3 kbp: both SW
scans take seconds a query at 16 kbp on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from kit4b_tpu import dna as jdna
from kit4b_tpu.align import blitz as jbl
from kit4b_tpu.index.sfx_index import SfxIndex as JIndex
from kit4b_tpu.io.fasta import Genome as JGenome
from kit4b_tpu.io.fasta import SeqRecord as JRecord
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import blitz as pbl
from kit4b_tpu_torch.device import DeviceUnavailable
from kit4b_tpu_torch.index.sfx_index import SfxIndex as PIndex
from kit4b_tpu_torch.io.fasta import Genome as PGenome
from kit4b_tpu_torch.io.fasta import SeqRecord as PRecord
from kit4b_tpu_torch.tools import make_longtail_golden as mg

GENOME, SMALL = mg.blitz_small()
QUERIES = dict(SMALL)
GAPPED = [n for n, c in SMALL if len(c) <= 3_000]
CHROMS = (("k1", 40_000), ("k2", 30_000), ("k3", 25_000))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _indexes(names, starts, lengths, seq):
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    return (JIndex.build(JGenome(names, starts, lengths, seq)),
            PIndex.build(PGenome(names, starts, lengths, seq)))


@pytest.fixture(scope="module")
def small_idx():
    """tests/test_blitz.py's index: one chromosome and the EOG."""
    seq = np.append(GENOME, jdna.BASE_EOG).astype(np.uint8)
    return _indexes(["cA"], np.array([0]), np.array([len(GENOME)]), seq)


@pytest.fixture(scope="module")
def multi():
    """Three chromosomes as Genome.from_records lays them out, and queries:
    one from each, one ending 50 bp before k2's end (its refinement window
    cut there) and one across k1's end into k2."""
    rng = np.random.default_rng(77)
    chroms = [rng.integers(0, 4, n).astype(np.uint8) for _, n in CHROMS]
    g = PGenome.from_records([PRecord(n, "", c)
                              for (n, _), c in zip(CHROMS, chroms)])
    idx = _indexes(g.names, g.starts, g.lengths, g.seq)
    qs = [("m1", chroms[0][5_000:7_000]),
          ("m2", jdna.revcomp(chroms[1][12_000:14_500])),
          ("m3", mg._mutate_subs(rng, chroms[2][3_000:5_000], 0.01)),
          ("m2end", chroms[1][30_000 - 1_550:30_000 - 50]),
          ("across", np.concatenate([chroms[0][-600:], chroms[1][:600]]))]
    return idx, qs


def _align(idx, queries, **kw):
    jh = jbl.blitz_align(idx[0], [JRecord(n, "", c) for n, c in queries],
                         **kw)
    ph = pbl.blitz_align(idx[1], [PRecord(n, "", c) for n, c in queries],
                         device="cpu", **kw)
    return jh, ph


def _fields(hits):
    return [dataclasses.asdict(h) for h in hits]


def test_exact_and_divergent_match_jax(small_idx):
    """tests/test_blitz.py's three queries, ungapped as that file runs
    them: equal hits, and its truth checks hold on the port's."""
    qs = [(f"q{i}", QUERIES[f"q{i}"]) for i in range(3)]
    jh, ph = _align(small_idx, qs)
    assert _fields(ph) == _fields(jh)
    by = {}
    for h in ph:
        by.setdefault(h.query, []).append(h)
    for i, (start, ln, strand) in enumerate(
            [(5_000, 2_000, "+"), (50_000, 5_000, "+"),
             (120_000, 3_000, "-")]):
        best = by[f"q{i}"][0]
        assert best.strand == strand
        assert abs(best.t_start - start) < 50
        assert best.matches > 0.9 * ln
        assert best.q_end - best.q_start > 0.9 * ln


@pytest.mark.parametrize("name", [n for n, _ in SMALL])
def test_ungapped_matches_jax(small_idx, name):
    jh, ph = _align(small_idx, [(name, QUERIES[name])])
    assert _fields(ph) == _fields(jh)


@pytest.mark.parametrize("name", GAPPED)
def test_gapped_matches_jax(small_idx, name):
    jh, ph = _align(small_idx, [(name, QUERIES[name])], gapped=True)
    assert _fields(ph) == _fields(jh)
    if name in ("rand", "short", "end"):
        assert ph == []


def test_gapped_spans_the_deletion(small_idx):
    """tests/test_blitz.py's gapped test on the port: one hit bridging the
    40 bp deletion, its blocks equal to the genome's bases."""
    q = QUERIES["gq"]
    (h, *_), = [pbl.blitz_align(small_idx[1], [PRecord("gq", "", q)],
                                gapped=True, device="cpu")]
    assert h.strand == "+" and abs(h.t_start - 200_000) < 20
    assert h.t_end - h.t_start > 0.95 * 3_000
    assert h.q_end - h.q_start > 0.95 * len(q)
    assert h.t_gaps >= 1 and h.t_gap_bases >= 30 and len(h.blocks) >= 2
    for qb, tb, bl in h.blocks:
        assert np.array_equal(q[qb:qb + bl], GENOME[tb:tb + bl])


def test_insertion_is_a_query_gap(small_idx):
    _, ph = _align(small_idx, [("ins30", QUERIES["ins30"])], gapped=True)
    assert ph[0].q_gaps >= 1 and ph[0].q_gap_bases >= 20
    assert {h.strand for h in _align(small_idx, [(
        "both", QUERIES["both"])], gapped=True)[1]} == {"+", "-"}


@pytest.mark.parametrize("gapped", [False, True])
def test_psl_bytes_match(small_idx, tmp_path, gapped):
    names = ["q0", "qq", "gq30", "both", "len2049"]
    qs = [(n, QUERIES[n]) for n in names]
    jh, ph = _align(small_idx, qs, gapped=gapped)
    q_lens = {n: len(c) for n, c in qs}
    t_lens = {"cA": len(GENOME)}
    jbl.write_psl(tmp_path / "j.psl", jh, q_lens, t_lens)
    pbl.write_psl(tmp_path / "p.psl", ph, q_lens, t_lens)
    text = (tmp_path / "p.psl").read_bytes()
    assert text == (tmp_path / "j.psl").read_bytes()
    assert text.startswith(b"psLayout version 3")
    assert text.count(b"\n") == 5 + len(ph) and len(ph) >= 5


@pytest.mark.parametrize("gapped", [False, True])
def test_three_chromosomes_match_jax(multi, gapped):
    idx, qs = multi
    jh, ph = _align(idx, qs, gapped=gapped)
    assert _fields(ph) == _fields(jh)
    by = {h.query: h for h in reversed(ph)}
    assert by["m2"].chrom == "k2" and by["m2"].strand == "-"
    assert by["m3"].chrom == "k3" and abs(by["m3"].t_start - 3_000) < 20
    assert by["m2end"].t_end <= 30_000


@pytest.mark.parametrize("kw", [
    dict(stride=2, min_hits=5, band=20, min_score=200),
    dict(stride=7, min_hits=1, band=4, min_score=-100),
    dict(max_hits_per_query=1, min_score=10),
    dict(gapped=True, min_score=1_500, sw_band=64),
    dict(gapped=True, max_hits_per_query=1, sw_band=128)])
def test_options_match_jax(small_idx, kw):
    qs = [(n, QUERIES[n]) for n in ("q0", "gq30", "both")]
    jh, ph = _align(small_idx, qs, **kw)
    assert _fields(ph) == _fields(jh)


def test_chain_and_score_rules_match_jax(small_idx):
    """`_chain_and_score` on hand-made seeds, given out of order: a group
    whose median diagonal is negative and not whole (-6.5: int() truncates
    it toward 0), one that would start before the genome (t0 = -1,
    dropped), one on one diagonal broken in two by a target jump of over
    100,000 (its second half past the query's end), and one on a single
    diagonal ordered by target."""
    q = GENOME[1_000:4_000].copy()
    qps = np.array([70, 10, 50, 30, 120, 100, 140, 1_020, 1_000, 101_520,
                    101_500, 2_000, 2_060, 2_020, 2_040], np.int64)
    tps = np.array([66, 3, 43, 24, 19, 0, 39, 6_020, 6_000, 106_520,
                    106_500, 2_500, 2_560, 2_520, 2_540], np.int64)
    for kw in (dict(min_hits=2, band=12, min_score=-10_000),
               dict(min_hits=3, band=30, min_score=-10_000),
               dict(min_hits=1, band=0, min_score=-10_000,
                    match=2, mismatch=-3)):
        got = pbl._chain_and_score(small_idx[1], q, qps, tps, strand="+",
                                   qname="h", **kw)
        want = jbl._chain_and_score(small_idx[0], q, qps, tps, strand="+",
                                    qname="h", **kw)
        assert _fields(got) == _fields(want), kw
        if kw["min_hits"] == 2:
            assert [h.t_start for h in got] == [4, 2_500, 6_000, 106_500]


def test_chain_past_the_genome_end_is_dropped(small_idx):
    """The `end` query's seeds chain into one group whose t1 passes
    len(g.seq); both packages drop it, so no hit remains."""
    q = QUERIES["end"]
    qps, tps = pbl._seed_hits(small_idx[1], q, 4)
    diag = tps - qps
    t0 = len(GENOME) - 1_000           # the query's first base
    own = np.abs(diag - t0) <= 12      # the planted chain; random seeds
    k = small_idx[1].lut_k             # lie far off its diagonals
    t1 = int(qps[own].max()) + k + int(np.median(diag[own]))
    assert own.sum() >= 3 and np.ptp(diag[own]) <= 12
    assert np.abs(diag[~own] - t0).min() > 12
    assert t1 > len(small_idx[1].genome.seq)
    assert _align(small_idx, [("end", q)])[1] == []


def test_n_at_a_sampled_window_start_raises_in_both(small_idx):
    """The known fault of the JAX package (ROADMAP queue C), kept: a
    sampled window that starts with an N indexes past the bucket table."""
    q = GENOME[40_000:41_000].copy()
    q[0] = jdna.BASE_N
    for mod, idx in ((jbl, small_idx[0]), (pbl, small_idx[1])):
        with pytest.raises(IndexError):
            mod._seed_hits(idx, q, 4)


def test_gapped_without_cuda_refuses_and_ungapped_stays_on_host(small_idx):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    recs = [PRecord("qq", "", QUERIES["qq"])]
    with pytest.raises(DeviceUnavailable):
        pbl.blitz_align(small_idx[1], recs, gapped=True)
    assert pbl.blitz_align(small_idx[1], recs)          # no device asked


@pytest.mark.parametrize("keep", [True, False])
def test_held_batches_count_and_hold_one_batch_a_query(small_idx, keep):
    """time_sw.held_batches, as the card's checks capture blitz's SW
    batches: one call a query with a chain, each batch held (or only
    counted) as banded_sw_batch receives it, at blitz's band and scores;
    the wrapped function restored after the block."""
    from kit4b_tpu_torch.pacbio import sswd
    from kit4b_tpu_torch.tools.time_sw import held_batches
    saved = sswd.banded_sw_batch
    recs = [PRecord(n, "", QUERIES[n]) for n in ("gq", "ins30", "rand")]
    with held_batches(sswd, hold=None if keep else (
            lambda mod, probes, held: False)) as held:
        hits = pbl.blitz_align(small_idx[1], recs, gapped=True,
                               device="cpu")
    assert sswd.banded_sw_batch is saved
    assert held.calls == len({h.query for h in hits}) == 2
    assert len(held) == (2 if keep else 0)
    for probes, plens, targets, tlens, diag0, band, scores in held:
        assert probes.shape[1] == plens.max() and band == 256
        assert scores == (1, -2, -3, -1)
        assert len(plens) == len(tlens) == len(diag0) == len(probes)
