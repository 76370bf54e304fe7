"""The paired-end device passes of the port on the CPU against the JAX
package's, bit for bit on the same inputs: `pe_pass_packed` (tier 1 alone,
tier 2 reached, tier 2 overflowing its E slots, the capped tier 3; max_ins
700, 65535 with inserts past 32,767, and 65536, which returns [B, 12]
rows), `deep_pe_pass_planes` (deep mate 1, 2 or both; rarest 4, 6 or all
windows; budgets (1, 64), (4, 128), (16, 128); a genome whose buckets pass
DFLT_SKIP_BUCKET; Ns on window edges) and `window_scan_pe` (both mates,
both strands, window starts before 0 and past G - L, at every phase
0-15, and a window with two equal minima)."""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.ops import pe_packed as ppk
from kit4b_tpu_torch.ops import seed_extend_deep as pdeep
from kit4b_tpu_torch.ops import seed_extend_fast as pfast
from kit4b_tpu_torch.ops.seed_extend_v4 import words_from_2bit
from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401
from torch_pe_cases import (Both, clean_genome, sim_pairs,
                            skip_bucket_genome, uploads)

B = 256


@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def clean():
    return Both(clean_genome())


@pytest.fixture(scope="module")
def repeats():
    return Both(mg.repeat_genome())


@pytest.fixture(scope="module")
def skipper():
    return Both(skip_bucket_genome())


def _kw(al, L, max_ins, tier2, tier3, min_ins=200):
    _, mtm = al.schedule_for(L)
    g = al.index.genome
    return dict(genome_len=len(g.seq), offsets=al._offsets_for(L, mtm),
                lut_k=al.index.lut_k, read_len=L, n_compact=al.n_compact,
                n_extend=al.n_extend, max_ml=al.max_ml, max_tot=mtm,
                mm_delta=al.mm_delta, min_ins=min_ins, max_ins=max_ins,
                tier2=tier2, tier3=tier3)


def _both_pass(both, a1, a2, **kw):
    """(JAX rows, port rows) of pe_pass_packed on one batch."""
    import jax.numpy as jnp

    from kit4b_tpu.ops import pe_packed as jpk
    L = a1.shape[1]
    jal, pal = both.aligners(len(a1))
    jh, ph = uploads(a1, a2)
    jg = jal._device_for(L)
    pg = pal._device_for(L)
    st = both.g.starts.astype(np.int32)
    want = np.asarray(jpk.pe_pass_packed(
        jg[0], jg[1], jg[3], jnp.asarray(st), *jh, **_kw(jal, L, **kw)))
    got = ppk.pe_pass_packed(pg[0], pg[1], pg[3], torch.from_numpy(st),
                             *ph, **_kw(pal, L, **kw)).numpy()
    return want, got


# (genome, read length, inserts, max_ins, tier2 E, tier3, what it reaches)
PASS_CASES = [
    ("clean", 100, (250, 450), 700, B, None, "tier1"),
    ("repeats", 100, (150, 700), 700, None, None, "overflow"),
    ("repeats", 100, (150, 700), 700, B, None, "tier2"),
    ("repeats", 150, (150, 700), 700, 16, None, "tier2_full"),
    ("repeats", 100, (150, 700), 700, 32, (16, 512), "tier3"),
    ("clean", 100, (33_000, 40_000), 65535, B, None, "long"),
    ("clean", 150, (33_000, 40_000), 65536, B, None, "long12"),
    ("repeats", 100, (150, 700), 65536, 16, None, "tier2_full12"),
]


@pytest.mark.parametrize("genome,L,ins,max_ins,E,tier3,reach", PASS_CASES)
def test_pe_pass_packed_matches_jax(request, genome, L, ins, max_ins, E,
                                    tier3, reach):
    both = request.getfixturevalue(genome)
    a1, a2, _ = sim_pairs(both.g, L, B, seed=L + E if E else L, ins=ins,
                          error_mode="illumina", subs_rate=0.02,
                          n_rate=0.005)
    tier2 = None if E is None else (E, 192, 96)
    want, got = _both_pass(both, a1, a2, max_ins=max_ins, tier2=tier2,
                           tier3=tier3)
    assert want.dtype == got.dtype == np.int32
    assert got.shape == (B, 6 if max_ins <= 65535 else 12)
    np.testing.assert_array_equal(got, want)
    rows = ppk.unpack_rows12(got)
    acc = rows[:, 5] == ppk.PAIR_ACCEPT
    n_ovf = int((rows[:, 5] == ppk.PAIR_OVERFLOW).sum())
    if reach == "tier1":
        assert n_ovf == 0 and acc.mean() > 0.9
    elif reach == "overflow":
        assert n_ovf > 16
    elif reach.startswith("tier2"):
        t1, _ = _both_pass(both, a1, a2, max_ins=max_ins, tier2=None,
                           tier3=None)
        n_t1 = int((ppk.unpack_rows12(t1)[:, 5] == ppk.PAIR_OVERFLOW).sum())
        if reach.startswith("tier2_full"):
            # more pairs overflow than tier 2 has slots: the rest keep
            # PAIR_OVERFLOW, at rows past the first E escalated
            assert n_t1 > E and n_ovf >= n_t1 - E
        else:
            assert n_t1 > n_ovf
    elif reach == "tier3":
        # the capped tier resolves the first E3 rows left after tier 2
        t2, _ = _both_pass(both, a1, a2, max_ins=max_ins, tier2=tier2,
                           tier3=None)
        n_t2 = int((ppk.unpack_rows12(t2)[:, 5] == ppk.PAIR_OVERFLOW).sum())
        assert n_t2 > tier3[0] and n_ovf == n_t2 - tier3[0]
    else:       # inserts past 32,767: word 2's sign bit set on the wire
        assert acc.mean() > 0.9 and rows[acc, 4].min() > 32767
        if max_ins == 65535:
            assert (got[acc, 2] < 0).all()


def test_pack_rows6_round_trip():
    rng = np.random.default_rng(5)
    rows = rng.integers(-5, 1 << 20, (64, 12)).astype(np.int32)
    rows[:, 4] = rng.integers(0, 65536, 64)
    rows[:3, 4] = (32767, 32768, 65535)
    rows[:, 5] = rng.integers(0, 4, 64)
    rows[:, 10:] = rng.integers(0, 2, (64, 2))
    rows[:, [2, 3, 8, 9]] = rng.integers(0, 256, (64, 4))
    w = ppk.pack_rows6(torch.from_numpy(rows)).numpy()
    assert w.dtype == np.int32 and (w[1:3, 2] < 0).all()
    np.testing.assert_array_equal(ppk.unpack_rows12(w), rows)


# (deep1, deep2, n_sel, (n_blocks, block_size)): each value of each knob
# at least twice
DEEP_CASES = [
    (True, False, 4, (1, 64)), (False, True, 6, (4, 128)),
    (True, True, None, (16, 128)), (True, True, 4, (1, 64)),
    (True, False, None, (4, 128)), (False, True, 4, (16, 128)),
]


def _deep_both(both, a1, a2, idxs, d1, d2, n_sel, budget, max_ins=600):
    """(JAX rows, port rows) of deep_pe_pass_planes on rows idxs of one
    batch's planes."""
    import jax.numpy as jnp

    from kit4b_tpu.ops import seed_extend_deep as jdeep
    from kit4b_tpu.ops.seed_extend_v4 import planes_2bit
    L = a1.shape[1]
    jal, pal = both.aligners(len(a1))
    jh, ph = uploads(a1, a2)
    outs = []
    for al, h, deep, planes, up in (
            (jal, jh, jdeep, lambda r, n: planes_2bit(r, n, read_len=L),
             jnp.asarray),
            (pal, ph, pdeep, lambda r, n: words_from_2bit(r, n, L),
             torch.from_numpy)):
        gv = al._device_for(L)
        kw = _kw(al, L, max_ins, None, None)
        for k in ("tier2", "tier3"):
            kw.pop(k)
        out = deep.deep_pe_pass_planes(
            gv[0], gv[1], gv[3], up(both.g.starts.astype(np.int32)),
            planes(h[0], h[1]), planes(h[2], h[3]),
            up(idxs.astype(np.int32)), deep1=d1, deep2=d2, n_sel=n_sel,
            n_blocks=budget[0], block_size=budget[1], **kw)
        outs.append(np.asarray(out))
    return outs


@pytest.mark.parametrize("d1,d2,n_sel,budget", DEEP_CASES)
def test_deep_pe_pass_planes_matches_jax(repeats, d1, d2, n_sel, budget):
    a1, a2, _ = sim_pairs(repeats.g, 100, B, seed=3, ins=(150, 700),
                          error_mode="illumina", subs_rate=0.02,
                          n_rate=0.01)
    # the rows that overflow the pass, padded to the E quantum with the
    # first of them, as the aligner submits them
    _, rows = _both_pass(repeats, a1, a2, max_ins=600, tier2=(B, 192, 96),
                         tier3=None)
    ovf = np.nonzero(ppk.unpack_rows12(rows)[:, 5] == ppk.PAIR_OVERFLOW)[0]
    assert len(ovf) > 8
    idxs = np.full(B, ovf[0])
    idxs[:len(ovf)] = ovf
    want, got = _deep_both(repeats, a1, a2, idxs, d1, d2, n_sel, budget)
    np.testing.assert_array_equal(got, want)
    out = ppk.unpack_rows12(got)
    if d1 and d2:       # the deep tier is total
        assert not (out[:, 5] == ppk.PAIR_OVERFLOW).any()
    assert (out[:, 5] == ppk.PAIR_ACCEPT).any()


@pytest.mark.parametrize("n_sel", [4, None])
def test_deep_pass_skips_buckets_past_maxiter(skipper, n_sel):
    """Reads over a unit planted 5,200 times (its buckets skipped) and
    reads with N bases at the first and last base of seed windows."""
    g = skipper.g
    rng = np.random.default_rng(8)
    L = 100
    starts = np.concatenate([rng.integers(100, 150_000, 96),
                             rng.integers(157_000, 159_500, 32)])
    a1 = g.seq[starts[:, None] + np.arange(L)].copy()
    m2 = g.seq[(starts + 200)[:, None] + np.arange(L)]
    a2 = np.where(m2 < 4, 3 - m2, m2)[:, ::-1].copy()     # insert 300
    _, pal = skipper.aligners(len(a1))
    _, mtm = pal.schedule_for(L)
    offs = pal._offsets_for(L, mtm)
    k = pal.index.lut_k
    for j, r in enumerate(range(96, 128, 2)):     # Ns on window edges
        o = offs[j % len(offs)]
        a1[r, o] = a1[r + 1, o + k - 1] = 4
    lut = skipper.idx.lut
    key = 0
    for b in g.seq[100:100 + k]:
        key = key * 4 + int(b)
    assert lut[key + 1] - lut[key] > pdeep.DFLT_SKIP_BUCKET
    idxs = np.arange(len(a1))
    want, got = _deep_both(skipper, a1, a2, idxs, True, True, n_sel,
                           (4, 128), max_ins=700)
    np.testing.assert_array_equal(got, want)
    out = ppk.unpack_rows12(got)
    assert (out[96:, 5] == ppk.PAIR_ACCEPT).mean() > 0.5


def test_window_scan_pe_matches_jax(clean):
    import jax.numpy as jnp

    from kit4b_tpu.ops import seed_extend_fast as jfast
    from kit4b_tpu.ops.seed_extend_v4 import planes_2bit
    g = clean.g
    G = len(g.seq)
    L, R, P = 100, 512, 501
    rng = np.random.default_rng(12)
    seq = g.seq.copy()
    # a probe with two equal minima in one window: its bases twice, 120
    # apart, inside the scan of row 0
    src = seq[5000:5000 + L].copy()
    seq[8000:8000 + L] = src
    seq[8120:8120 + L] = src
    both = Both(type(g)(g.names, g.starts, g.lengths, seq))
    gs = both.g.seq
    loci = rng.integers(0, G - L - 1, R)
    loci[0] = 8000
    m1 = gs[loci[:, None] + np.arange(L)].copy()
    m2 = np.where(m1 < 4, 3 - m1, m1)[:, ::-1].copy()    # revcomp
    m1[1:][rng.random(m1[1:].shape) < 0.01] = 4
    which = rng.integers(1, 3, R).astype(np.int32)
    want_strand = rng.integers(0, 2, R).astype(np.int32)
    idxs = rng.permutation(R).astype(np.int32)
    idxs[0] = 0
    which[0], want_strand[0] = 1, 0
    # rows 1-16 scan for their own locus: mate 1's forward words, mate
    # 2's reverse complement
    which[1:17] = np.repeat([1, 2], 8)
    want_strand[1:17] = np.repeat([0, 1], 8)
    tgt = loci[idxs]
    starts = (tgt - rng.integers(0, P - 16, R)).astype(np.int32)
    starts[0] = 8000 - 40
    starts[1:17] = ((tgt[1:17] - 200) & ~15) + np.arange(16)  # phases 0-15
    starts[17:20] = (-30, -501, -1)                          # before 0
    starts[20:23] = (G - L - 3, G - L + 40, G + 10)          # past G - L
    _, ph = uploads(m1, m2)
    jal, pal = both.aligners(R)
    jh, _ = uploads(m1, m2)
    jplanes = [planes_2bit(jh[i], jh[i + 1], read_len=L) for i in (0, 2)]
    pplanes = [words_from_2bit(ph[i], ph[i + 1], L) for i in (0, 2)]
    kw = dict(genome_len=G, scan_len=P, read_len=L)
    want = [np.asarray(x) for x in jfast.window_scan_pe(
        jal._device_for(L)[0], *jplanes, *(jnp.asarray(a) for a in (
            idxs, which, want_strand, starts)), **kw)]
    got = [x.numpy() for x in pfast.window_scan_pe(
        pal._device_for(L)[0], *pplanes, *(torch.from_numpy(a) for a in (
            idxs, which, want_strand, starts)), **kw)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    best, bpos, n_best = got
    assert n_best[0] == 2 and best[0] == 0 and bpos[0] == 8000
    assert set((starts[1:17] & 15).tolist()) == set(range(16))
    assert (best[1:17] <= 3).all() and (bpos[1:17] == tgt[1:17]).all()
    # a window wholly before 0 or past G - L holds no position
    assert best[18] == best[22] == np.iinfo(np.int32).max
