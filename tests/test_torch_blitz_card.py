"""blitz on the card: the SW batches that its gapped refinement sends (one a
query: B 1-4 chains, W 256, Lp the query padded to 512, from 512 to
16,896) through both kernels of csrc/sw.cu, held to their plain PyTorch
versions (the whole pointer array and every output equal); and the port's
blitz, hrdx and kmerdist, with the rest of the long-tail commands, on
CUDA against the committed JAX golden
(kit4b_tpu_torch/data/longtail_golden.npz). This file imports no jax, so
on a machine with a card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_blitz_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.align import blitz
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.pacbio import sswd
from kit4b_tpu_torch.tools import make_longtail_golden as mg
from kit4b_tpu_torch.tools.time_sw import held_batches, on_card

# (query length, chains): Lp 512, 1,024 (a multiple of 512), 2,560 (2,049
# bp, one past one), 8,704 and 16,896, with one to four chains a batch
SHAPES = [(300, 1), (1_024, 2), (2_049, 3), (8_600, 4), (16_450, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def index():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    rng = np.random.default_rng(2814)
    g = Genome.from_records([SeqRecord(f"c{i}", "", rng.integers(
        0, 4, n).astype(np.uint8)) for i, n in enumerate((150_000, 90_000))])
    return SfxIndex.build(g)


def _chains(index, name, codes):
    """The chains `blitz_align` sends to `_refine_gapped` for one query in
    gapped mode (both strands, no ungapped score threshold)."""
    hits = []
    for strand, q in (("+", codes), ("-", dna.revcomp(codes))):
        qps, tps = blitz._seed_hits(index, q, 4)
        hits += blitz._chain_and_score(index, q, qps, tps, strand=strand,
                                       qname=name, min_hits=3, band=12,
                                       min_score=-(1 << 30))
    return hits


def _batch(index, length, chains, dev):
    """The batch `_refine_gapped` sends for one planted query of `length`
    bp (a 25 bp deletion in its middle half, either strand), its chains
    best ungapped score first (on this small genome the index's short LUT
    key also chains random seeds) cycled to `chains` hits, as
    banded_sw_batch receives it."""
    rng = np.random.default_rng(length)
    name, codes = mg.planted_queries(
        rng, [("c0", index.genome.chrom_codes(0))], 1, 0,
        (length, length), indel=(25, 25))[0]
    rec = SeqRecord(name, "", codes)
    hits = sorted(_chains(index, name, codes), key=lambda h: -h.score)
    assert hits
    hits = [hits[i % len(hits)] for i in range(chains)]
    with held_batches(sswd) as held:
        out = blitz._refine_gapped(index, rec, hits, 256, 50, device=dev)
    return held[0], out


@pytest.mark.cuda
@pytest.mark.parametrize("length,chains", SHAPES)
def test_blitz_batches_match_plain(cuda, index, length, chains):
    batch, out = _batch(index, length, chains, cuda)
    (p, t, pl, tl, d0), kw = on_card(torch, batch, cuda)
    B, Lp = p.shape
    assert (B, kw["W"]) == (chains, 256) and Lp % 512 == 0
    got = sw.sw_scan(p, t, pl, tl, d0, **kw)
    want = sw.sw_scan_plain(p, t, pl, tl, d0, **kw)
    for name, g, w in zip(("best", "bi", "bk", "ptrs"), got, want):
        assert torch.equal(g, w), name
    best, bi, bk, ptrs = got
    for L_OPS in (Lp + 256, 37):
        args = (ptrs, p, t, best, bi, bk, d0)
        for name, g, w in zip(
                ("ops", "n", "ps", "ts", "nm", "nmm"),
                sw.sw_traceback(*args, W=256, L_OPS=L_OPS),
                sw.traceback_plain(*args, W=256, L_OPS=L_OPS)):
            assert torch.equal(g, w), (name, L_OPS)
    assert out and max(h.t_gap_bases for h in out) >= 12


@pytest.mark.cuda
def test_blitz_launches_one_batch_a_query(cuda, index):
    qs = mg.planted_queries(np.random.default_rng(5), [
        ("c1", index.genome.chrom_codes(1))], 6, 2, (800, 3_000))
    chained = sum(bool(_chains(index, n, c)) for n, c in qs)
    assert chained >= 6
    sw.sw_scan.launches = sw.sw_traceback.launches = 0
    hits = blitz.blitz_align(index, [SeqRecord(n, "", c) for n, c in qs],
                             gapped=True, device=cuda)
    assert sw.sw_scan.launches == sw.sw_traceback.launches == chained
    assert {h.query for h in hits} == {n for n, _ in qs[:6]}


@pytest.mark.cuda
def test_port_on_cuda_matches_golden(cuda):
    with np.load(mg.GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    out = mg.compute(mg.port_fns(cuda), big=True)
    assert mg.differing(out, gold) == []
    assert mg.check_reach(out) == []
