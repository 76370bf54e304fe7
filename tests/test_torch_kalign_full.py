"""The port's full-stats kalign path against the JAX package on the same
numpy inputs, exactly (every value is an integer or a string):
`fast_pass_v3` on JAX's own cases of tests/test_seed_extend_v3.py, the
`align_records` stream of `KAligner` with the microInDel, splice and
chimeric rescues (-y 20, -l 10000, -C 50 and all three) on the inputs of
tests/test_indel.py, tests/test_splice.py and tests/test_simreads2.py and
on a repeat-dense genome where the host ladder runs both its tiers,
`align_batch(return_raw=True)`, and `remove_orphan_junctions`."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.align import phases as jph
from kit4b_tpu.ops import seed_extend_v3 as jv3
from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.align import phases as pph
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
from kit4b_tpu_torch.ops import seed_extend_v3 as pv3
from kit4b_tpu_torch.sim import simreads
from kit4b_tpu_torch.tools import make_kalign_full_golden as mg
from test_seed_extend_v3 import _mk, _setup
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import Both

BATCH = 256
CONFIGS = {"y": dict(micro_indel=20), "l": dict(splice_max=10_000),
           "C": dict(chimeric_pct=50),
           "ylC": dict(micro_indel=20, splice_max=10_000, chimeric_pct=50)}


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


# --- fast_pass_v3 -----------------------------------------------------------

V3_CASES = {   # name: (_mk arguments, n_compact, n_extend, max_per_bucket)
    "basic": ({}, 32, None, None),
    "ns": (dict(with_ns=True), 32, None, None),
    "repeats-nc16": (dict(repeat=True, subs_rate=0.05), 16, None, None),
    "repeats-nc16-cap3": (dict(repeat=True, subs_rate=0.05), 16, None, 3),
    "n_extend2": (dict(repeat=True, subs_rate=0.0, n_reads=64), 32, 2, None),
}


@pytest.mark.parametrize("name", list(V3_CASES))
def test_fast_pass_v3_matches_jax(name):
    """The six outputs of the port's fast_pass_v3 (2-bit reads, v4 core)
    equal JAX's (byte reads, v3 core) on the same device tables."""
    mk, nc, ne, cap = V3_CASES[name]
    _, idx, reads = _mk(**mk)
    gview, sa, _, lut2, offsets, G = _setup(idx, reads)
    kw = dict(genome_len=G, offsets=offsets, lut_k=idx.lut_k, n_compact=nc,
              max_ml=8, n_extend=ne, max_per_bucket=cap)
    want = jv3.fast_pass_v3(gview, sa, lut2, jnp.asarray(reads), **kw)
    r2b, nlist = pk.pack_reads_2bit(reads)
    got = pv3.fast_pass_v3(
        torch.from_numpy(np.asarray(gview).astype(np.int64)),
        torch.from_numpy(np.array(sa)), torch.from_numpy(np.array(lut2)),
        torch.from_numpy(r2b), torch.from_numpy(nlist),
        read_len=reads.shape[1], **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    if name in ("repeats-nc16", "n_extend2"):   # overflow flagged
        assert got["overflow"].any()


# --- the aligner's stream with the rescues ----------------------------------

def _genome(seed, n):
    rng = np.random.default_rng(seed)
    return rng, Genome(["c1"], np.array([0]), np.array([n]), np.append(
        rng.integers(0, 4, n), dna.BASE_EOG).astype(np.uint8))


def _indel_inputs():
    """tests/test_indel.py: deletion, insertion, chimeric and plain reads."""
    _, g = _genome(19, 150_000)
    s = g.seq
    recs = []
    for i in range(20):
        start, d, split = 1000 + i * 500, 1 + i % 8, 30 + (i * 7) % 40
        recs.append(SeqRecord(f"del{i}", "", np.concatenate(
            [s[start:start + split],
             s[start + split + d:start + split + d + 100 - split]])))
    rng = np.random.default_rng(3)
    for i in range(20):
        start, d, split = 60_000 + i * 500, 1 + i % 8, 30 + (i * 7) % 40
        recs.append(SeqRecord(f"ins{i}", "", np.concatenate(
            [s[start:start + split], rng.integers(0, 4, d).astype(np.uint8),
             s[start + split:start + 100 - d]])))
    rng = np.random.default_rng(7)
    for i in range(12):
        start, keep = 3_000 + i * 700, 60 + (i * 5) % 30
        t5 = (i * 3) % (100 - keep)
        recs.append(SeqRecord(f"ch{i}", "", np.concatenate(
            [rng.integers(0, 4, t5), s[start:start + keep],
             rng.integers(0, 4, 100 - keep - t5)]).astype(np.uint8)))
    recs.append(SeqRecord("plain", "", s[5000:5100].copy()))
    return g, recs


def _splice_inputs():
    """tests/test_splice.py: 15 two-exon reads on canonical introns."""
    _, g = _genome(29, 200_000)
    seq = g.seq
    recs = []
    for i in range(15):
        start, split, gap = 2_000 + i * 2_000, 30 + (i * 9) % 40, 200 + i * 37
        seq[start + split:start + split + 2] = (2, 3)
        seq[start + split + gap - 2:start + split + gap] = (0, 2)
        recs.append(SeqRecord(f"sj{i}", "", np.concatenate(
            [seq[start:start + split],
             seq[start + split + gap:start + gap + 100]]).copy()))
    return g, recs


def _simreads_inputs():
    """tests/test_simreads2.py: InDel reads and 3' adapter artefacts."""
    _, g = _genome(7, 120_000)
    return g, (simreads.sim_reads(g, simreads.SimParams(
        n_reads=200, read_len=100, indel_rate=1.0, indel_size=5, seed=10))
        + simreads.sim_reads(g, simreads.SimParams(
            n_reads=200, read_len=100, artef3_rate=1.0, seed=11)))


def _repeat_inputs():
    """The full-stats golden's repeat-dense genome and its single-end
    reads of both lengths."""
    g, _, se, _ = mg.workload()
    return g, se[:600]


INPUTS = {"indel": _indel_inputs, "splice": _splice_inputs,
          "simreads": _simreads_inputs, "repeats": _repeat_inputs}


@pytest.fixture(scope="module", params=list(INPUTS))
def workload(request):
    g, recs = INPUTS[request.param]()
    return request.param, Both(g), recs


def _key(res):
    return (res.nar, int(res.strand), int(res.pos), int(res.mm),
            int(res.n_low), int(res.nxt_mm),
            None if res.multi_ids is None else res.multi_ids.tolist(),
            res.cigar, res.secondary)


def _ladder_spy(al, calls):
    """Records the capacity of each host-ladder call of one aligner."""
    submit = al._submit

    def spy(reads, n_compact=None, **kw):
        if n_compact is not None:
            calls.append(n_compact)
        return submit(reads, n_compact=n_compact, **kw)
    al._submit = spy


@pytest.mark.parametrize("config", list(CONFIGS))
def test_align_records_matches_jax(workload, config):
    name, both, recs = workload
    ja, pa = both.aligners(BATCH, **CONFIGS[config])
    calls = ([], [])
    _ladder_spy(ja, calls[0])
    _ladder_spy(pa, calls[1])
    want = [(r.name, _key(res)) for r, res in ja.align_records(recs)]
    got = [(r.name, _key(res)) for r, res in pa.align_records(recs)]
    assert got == want
    assert calls[0] == calls[1]
    cigars = "".join(k[7] or "" for _, k in got)
    for flag, ops in (("y", "ID"), ("l", "N"), ("C", "S")):
        if flag in config and name in {"y": ("indel", "simreads"),
                                       "l": ("splice",),
                                       "C": ("indel", "simreads")}[flag]:
            assert any(op in cigars for op in ops), (flag, name)
    if name == "repeats":   # the ladder ran both its tiers, on both sides
        assert set(calls[1]) == {nct for _, nct in pa.escalation}


@pytest.mark.parametrize("config", [None, "ylC"])
def test_align_batch_return_raw_matches_jax(workload, config):
    _, both, recs = workload
    ja, pa = both.aligners(BATCH, **CONFIGS.get(config, {}))
    L = len(recs[0].codes)
    arr = pa._pad_batch([r for r in recs if len(r.codes) == L][:BATCH])
    jres, jraw = ja.align_batch(arr, return_raw=True)
    pres, praw = pa.align_batch(arr, return_raw=True)
    assert [_key(r) for r in pres] == [_key(r) for r in jres]
    assert sorted(praw) == sorted(jraw)
    for key in jraw:
        np.testing.assert_array_equal(praw[key], jraw[key], err_msg=key)
    assert (praw["hit_id"] != pk.INT32_MAX).any()


# --- orphan junction removal ------------------------------------------------

def _junction_list(cigars):
    """(rec, res) pairs of accepted reads at 1000 + 3 * i with the CIGARs,
    plus a multi read."""
    out = [(SeqRecord(f"r{i}", "", np.zeros(100, np.uint8)),
            pk.AlignResult("accepted", pos=1000 + 3 * i, mm=0, n_low=1,
                           cigar=c))
           for i, c in enumerate(cigars)]
    out.append((SeqRecord("m", "", np.zeros(100, np.uint8)),
                pk.AlignResult("multi", mm=1, n_low=2)))
    return out


ORPHAN_CASES = {
    "splice": ["40M500N60M", "37M500N63M", "30M900N70M", "100M",
               "50M2D50M", "10S90M"],
    "indel": ["40M2D60M", "37M2D63M", "20M3I77M", "60M1D40M", "40M500N60M",
              "50M4I46M"],
    "splice-single": ["40M500N60M", "20M3I77M", "100M"],
    "indel-single": ["40M500N60M", "20M3D80M"],
    "indel-none": ["100M", "5S95M"],
}


@pytest.mark.parametrize("case", list(ORPHAN_CASES))
def test_remove_orphan_junctions_matches_jax(case):
    kind = case.split("-")[0]
    aligned = _junction_list(ORPHAN_CASES[case])
    jal = [(r, jk.AlignResult(**{k: v for k, v in vars(res).items()}))
           for r, res in copy.deepcopy(aligned)]
    n_port = pph.remove_orphan_junctions(aligned, kind)
    n_jax = jph.remove_orphan_junctions(jal, kind)
    assert n_port == n_jax
    assert [res.nar for _, res in aligned] == [res.nar for _, res in jal]
    assert (pph.NAR_ORPHAN_SPLICE, pph.NAR_ORPHAN_INDEL) == \
        (jph.NAR_ORPHAN_SPLICE, jph.NAR_ORPHAN_INDEL)
    for (_, a), (_, b) in zip(aligned, jal):
        assert pph._junction(a) == jph._junction(b)
    if case.endswith("single"):
        assert n_port == 1
