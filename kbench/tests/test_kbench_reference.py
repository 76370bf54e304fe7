"""The plain references agree with the port at a tiny size on the CPU, and
each cell's control (the reference with a stated guarantee broken) fails
the comparison a run makes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kbench import control, recipes
from kbench.jobs import hammings_node, hammings_restricted
from kbench.reference import hammings as href
from kbench.reference import kalign_se as kref
from conftest import CELLS, tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    from kit4b_tpu_torch import native
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"the port's host library is not available: {e}")


def _r64(seed=11):
    _, _, config, _ = tiny(CELLS[0])
    return hammings_node.make_genome(seed, config)


@pytest.mark.parametrize("node,numnodes,antisense",
                         [(0, 1, True), (0, 4, True), (2, 3, True),
                          (0, 2, False)])
def test_node_min_equals_the_port_everywhere(node, numnodes, antisense):
    from kit4b_tpu_torch.kmer import hammings
    _, _, seq, _, _ = _r64()
    got = hammings.hammings_exhaustive(seq, 25, antisense=antisense,
                                       node=node, numnodes=numnodes,
                                       device="cpu")
    pos = np.arange(len(seq))
    want = href.node_min(seq, 25, pos, node, numnodes, antisense, CPU)
    assert np.array_equal(got, want)
    assert (want == 0).any() and (want < 0xFFFF).sum() > 0.9 * len(seq)


def test_node_min_equals_the_ports_oracle_on_the_whole_genome():
    from kit4b_tpu_torch.kmer import hammings
    seq = recipes.concat(recipes.random_genome(
        4, {"name": "g", "length": 1500})[1])
    seq[300:330] = recipes.BASE_N
    pos = np.arange(len(seq))
    assert np.array_equal(href.node_min(seq, 7, pos, 0, 1, True, CPU),
                          hammings.hammings_oracle(seq, 7))


def test_restricted_keeps_the_rule_and_the_port_keeps_it_too():
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.kmer import hammings
    names, chroms, seq, _, _ = _r64(12)
    g = hammings_restricted._genome(names, chroms)
    got = hammings.hammings_restricted(SfxIndex.build(g), 25, max_hamming=3,
                                       device="cpu")
    nk = len(seq) - 24
    isn = np.concatenate([[0], np.cumsum(seq >= 4)])
    clean = np.nonzero(isn[25:nk + 25] - isn[:nk] == 0)[0]
    true = href.restricted_true(seq, 25, clean, True, CPU)
    lut_k = href.pick_lut_k(len(seq))
    assert lut_k == SfxIndex.build(g).lut_k
    ok = href.restricted_rule(got[clean].astype(np.int64), true, 25, 3,
                              lut_k)
    assert ok.all()
    assert (true <= 1).sum() > 100        # the planted copies are reached
    # exhaustive mode leaves out partners across a separator, which
    # restricted mode counts with a mismatch there: never a lower minimum
    ex = href.node_min(seq, 25, clean, 0, 1, True, CPU)
    assert (np.minimum(true, 25) <= ex).all()
    assert (np.minimum(true, 25) == ex).mean() > 0.99


def test_kalign_reference_equals_the_port():
    from kit4b_tpu_torch.align import kalign
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import Genome
    names, chroms, _ = recipes.genome(5, {"recipe": "random", "name": "g",
                                          "length": 30_000})
    # a repeat, so that some reads have two best loci
    chroms[0][20_000:20_400] = chroms[0][5_000:5_400]
    seq = recipes.concat(chroms)
    _, reads, _ = recipes.illumina_se_reads(
        6, "g", chroms[0], {"n_reads": 2_000, "read_len": 100,
                            "subs_rate": 0.02})
    reads[7, 10] = recipes.BASE_N
    reads[8, 10:13] = recipes.BASE_N
    g = Genome(["g"], np.array([0]), np.array([len(chroms[0])]), seq)
    al = kalign.KAligner(SfxIndex.build(g), batch_size=2_048, device="cpu")
    raw = al._collect_raw(al._submit(reads), reads)
    rule = {"max_subs": 5, "mm_delta": 1, "max_ns": 1}
    want = kref.align(seq, reads, rule, CPU)
    acc = raw["nar"] == 0
    assert np.array_equal(acc, want["accepted"])
    assert np.array_equal(raw["pos"][acc], want["pos"][acc])
    assert np.array_equal(raw["strand"][acc], want["strand"][acc])
    assert np.array_equal(raw["mm"][acc], want["nm"][acc])
    assert 0.8 * len(reads) < acc.sum() < len(reads)
    assert (raw["nar"] == 2).sum() > 0 and not want["accepted"][8]


@pytest.mark.parametrize("name", CELLS)
def test_each_cells_control_fails_its_comparison(name):
    bench, _, config, traffic = tiny(name)
    for seed in (2**31 + 1, 17, 4_000_000_007):
        got = control.control_readings(bench, name, seed, CPU, config,
                                       traffic)
        assert any(v > lim for v, lim in got.values()), (seed, got)
