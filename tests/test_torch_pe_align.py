"""`PeAligner.align_pairs` of the port on the CPU against the JAX package's,
the whole (name1, name2, PePair) stream equal:

- pe modes 1-4 on the golden's repeat-dense workload (2 x 100 bp, two
  batches of 1,024 in one superbatch group), every escalation stage of the
  mode asserted reached on both sides through the same spies, and PAIR_MULTI
  rows and pairs of two unique mates rejected by their insert among the
  rows the host resolves;
- cases built to break a shortcut: more pairs overflowing than tier 2's E
  slots, loci duplicated across strands and seed windows, mates on two
  chromosomes, and an insert exactly at -d and at -D.
"""
import contextlib

import numpy as np
import pytest

from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import pe as ppe
from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import (Both, clean_genome, pair_key, records,
                            sim_pairs)

# the stages of each mode that must be reached
REACH = {1: ("overflow", "rescue_before_deep", "deep1", "rescue_after_deep",
             "deep2b", "deep3", "orphan_rescue"),
         2: ("overflow", "deep1", "deep3"),
         3: ("overflow", "rescue_before_deep", "deep1", "rescue_after_deep",
             "deep2b", "deep3", "orphan_rescue"),
         4: ("overflow", "deep1", "deep3")}


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def golden_work():
    g, _, reads = mg.workload()
    return Both(g), reads[100]


@contextlib.contextmanager
def row_spy(pe_cls, seen: list):
    """Keeps a copy of the rows each _resolve_rows call starts from (both
    packages: (self, out, n, ...))."""
    orig = pe_cls._resolve_rows

    def spy(self, out, n, *a, **kw):
        seen.append(out[:n].copy())
        yield from orig(self, out, n, *a, **kw)
    pe_cls._resolve_rows = spy
    try:
        yield seen
    finally:
        pe_cls._resolve_rows = orig


def run_both(both, recs1, recs2, batch, tier2=None, **pe_kw):
    """(JAX stream, port stream, JAX spied counts, port spied counts, JAX
    rows, port rows, port aligner) of one align_pairs call."""
    from kit4b_tpu.align import pe as jpe
    jal, pal = both.aligners(batch)
    out = []
    for pkg, al, cls in (("jax", jal, jpe.PeAligner),
                         ("port", pal, ppe.PeAligner)):
        a = cls(al, **pe_kw)
        if tier2 is not None:
            a.tier2 = tier2
        names = [r.name for r in recs1], [r.name for r in recs2]
        r1 = records([r.codes for r in recs1], names[0], pkg)
        r2 = records([r.codes for r in recs2], names[1], pkg)
        with mg.stage_spy(cls, {}) as counts, row_spy(cls, []) as rows:
            stream = [(x.name, y.name, pair_key(pp))
                      for x, y, pp in a.align_pairs(r1, r2)]
        out.append((stream, counts, np.concatenate(rows), a))
    (js, jc, jr, _), (ps, pc, pr, pa) = out
    return js, ps, jc, pc, jr, pr, pa


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_align_pairs_matches_jax_in_every_pe_mode(golden_work, mode):
    both, (recs1, recs2) = golden_work
    js, ps, jc, pc, jr, pr, pal = run_both(
        both, recs1, recs2, mg.BATCH, pair_min_len=mg.MIN_INS,
        pair_max_len=mg.MAX_INS, pe_mode=mode)
    assert ps == js
    np.testing.assert_array_equal(pr, jr)
    pc["overflow"] = jc["overflow"] = int((pr[:, 5] == 3).sum())
    assert pc == jc
    assert [k for k in REACH[mode] if not jc.get(k)] == []
    for k in REACH[mode]:
        assert pal.stage_rows[k] == pc[k], k
    assert (pr[:, 5] == ppe.PAIR_MULTI).any()
    assert ((pr[:, 5] == ppe.PAIR_NONE) & (pr[:, 6] >= 0)
            & (pr[:, 7] >= 0)).any()
    acc = [k for _, _, k in ps if k[0] == ppe.NAR_PE_ACCEPTED]
    assert len(acc) > 0.4 * len(ps)
    if mode in (3, 4):      # orphans fall back to SE acceptance
        assert any(k[0] == ppe.NAR_PE_NOPAIR and (k[1] or k[2])
                   for _, _, k in ps)
    if mode in (1, 3):
        assert any(k[4] for k in acc)


def test_more_overflowing_pairs_than_tier2_slots(golden_work):
    """Tier 2 of 16 slots: the rest of a batch's overflowed pairs reach
    the host escalation untouched by tier 2."""
    both, (recs1, recs2) = golden_work
    js, ps, jc, pc, jr, pr, _ = run_both(
        both, recs1[:512], recs2[:512], 512, tier2=(16, 192, 96),
        pair_min_len=mg.MIN_INS, pair_max_len=mg.MAX_INS, pe_mode=1)
    assert ps == js and pc == jc
    np.testing.assert_array_equal(pr, jr)
    assert (pr[:, 5] == 3).sum() > 100


def test_loci_duplicated_across_strands_and_windows(golden_work):
    """Pairs from chr1:69,800-70,800, whose 600 bp at 70,000 sit again
    reverse-complemented on chr2: each mate has hits on both strands, from
    several seed windows; the insert and orientation pick the pair."""
    from kit4b_tpu_torch.sim import simreads
    both, _ = golden_work
    r1, r2 = simreads.sim_reads(both.g, simreads.SimParams(
        n_reads=256, read_len=100, pe=True, pe_insert_min=200,
        pe_insert_max=400, seed=17, regions=[("chr1", 69_800, 70_800)],
        error_mode="illumina", subs_rate=0.01))
    js, ps, _, _, jr, pr, _ = run_both(both, r1, r2, mg.BATCH,
                                       pair_min_len=mg.MIN_INS,
                                       pair_max_len=mg.MAX_INS, pe_mode=1)
    assert ps == js
    np.testing.assert_array_equal(pr, jr)
    # fragments wholly inside the copied 600 bp pair equally well on both
    # chromosomes (multi); the others pair on chr1 only
    assert (pr[:, 5] == ppe.PAIR_MULTI).sum() > 0.2 * len(pr)
    acc = [k for _, _, k in ps if k[0] == ppe.NAR_PE_ACCEPTED]
    assert len(acc) > 0.4 * len(ps)


def test_mates_on_two_chromosomes_never_pair(golden_work):
    both, (recs1, recs2) = golden_work
    swapped = [i for i, (a, b) in enumerate(zip(recs1, recs2))
               if a.name.split("|")[2] != b.name.split("|")[2]]
    assert len(swapped) == 2 * mg.N_SWAP
    js, ps, _, _, jr, pr, _ = run_both(
        both, [recs1[i] for i in swapped], [recs2[i] for i in swapped],
        mg.BATCH,
        pair_min_len=mg.MIN_INS, pair_max_len=mg.MAX_INS, pe_mode=2)
    assert ps == js
    assert all(k[0] == ppe.NAR_PE_NOPAIR for _, _, k in ps)
    # most mates align uniquely on their own chromosome
    assert ((pr[:, 6] >= 0) & (pr[:, 7] >= 0)).mean() > 0.5


@pytest.mark.parametrize("dmin,dmax,accepted", [
    (300, 300, True), (301, 400, False), (200, 299, False)])
def test_insert_exactly_at_the_bounds(dmin, dmax, accepted):
    """Every fragment is 300 bp: -d 300 -D 300 accepts it, -d 301 and
    -D 299 reject it."""
    both = Both(clean_genome(60_000, seed=3))
    c1, c2, names = sim_pairs(both.g, 100, 128, seed=5, ins=(300, 300))
    js, ps, _, _, _, pr, _ = run_both(
        both, records(c1, names), records(c2, names), 128,
        pair_min_len=dmin, pair_max_len=dmax, pe_mode=2)
    assert ps == js
    acc = np.array([k[0] == ppe.NAR_PE_ACCEPTED for _, _, k in ps])
    assert acc.all() if accepted else not acc.any()
    if accepted:
        assert {k[3] for _, _, k in ps} == {300}
