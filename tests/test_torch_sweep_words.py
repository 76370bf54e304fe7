"""Word-level model of the offset-sweep CUDA kernel
(kit4b_tpu_torch/csrc/sweep.cu), held exactly to `sweep_plain` on the CPU.

The kernel cannot run without a card, so its arithmetic is written here a
second time in numpy on uint32 words, function by function under the names
the `.cu` uses: `stage` (codes to bit-plane words and window validity),
`five` and `window_sums` (the K-window mismatch counts of 32 starts as five
bit planes, by the 5+5 carry-save network, for every K in 1..25),
`slice_min` (the running minimum kept in planes, 31 meaning "no pair yet"),
`unpack`, and `sweep_block` / `sweep_model` (the block's offset range, the
warps' shares, the lanes' words, the fold). Bit b of every word belongs to
own start b; a lane of the kernel is one element of the arrays here.

The model also counts its shifts and three-input gates per step, which
`kit4b_tpu_torch.tools.time_sweep.ops_per_step` states in closed form for
the kernel's own instruction floor. Every value is an integer, so every
comparison is exact.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kernels.sweep import BIG, sweep_plain
from kit4b_tpu_torch.tools import time_sweep

U = np.uint32
ONES = U(0xFFFFFFFF)
NONE = 31                 # all five planes set: no valid pair yet (K <= 25)
LANE_WORDS, SPAN, WARPS = 4, 2048, 8     # the kernel's constants


class Ops:
    """Shifts and three-input gates executed (`n`) and steps made by
    `sweep_block` (`steps`) since the last reset."""
    n = 0
    steps = 0


def fsr(lo, hi, s):
    """__funnelshift_r: the low word of (hi:lo) >> s, 0 <= s < 32."""
    if s == 0:
        return lo
    Ops.n += 1
    return (lo >> U(s)) | (hi << U(32 - s))


def shr(x, s):
    Ops.n += 1
    return x >> U(s)


def xor3(a, b, c):
    Ops.n += 1
    return a ^ b ^ c


def maj(a, b, c):
    Ops.n += 1
    return (a & b) | (a & c) | (b & c)


def gate(x):
    """Any other function of at most three words: one instruction."""
    Ops.n += 1
    return x


def stage(codes, lim, p0, nw, K):
    """Positions [p0, p0 + 32 nw) as words b0, b1, b2 (bits 0-2 of the
    codes) and ok (bit b: the K-window starting there holds no sentinel and
    ends before lim); positions at or past lim read as a sentinel."""
    pos = p0 + np.arange(32 * (nw + 1))
    c = np.where(pos < lim, codes[np.minimum(pos, len(codes) - 1)], 0x0F)

    def words(bits):
        return np.packbits(bits.reshape(-1, 32).astype(np.uint8), axis=1,
                           bitorder="little").view("<u4").reshape(-1)
    sent = words(c >= 5)
    any_ = np.zeros(nw, U)
    for k in range(K):
        any_ |= sent[:nw] if k == 0 else \
            (sent[:nw] >> U(k)) | (sent[1:] << U(32 - k))
    return {"b0": words(c & 1)[:nw], "b1": words(c & 2)[:nw],
            "b2": words(c & 4)[:nw], "ok": ~any_}


def five(a, b, c, d, e):
    """Sum of five one-bit words as three planes: two full adders, two
    gates."""
    s1, c1 = xor3(a, b, c), maj(a, b, c)
    s2, c2 = xor3(s1, d, e), maj(s1, d, e)
    return [s2, gate(c1 ^ c2), gate(c1 & c2)]


def direct(K, p):
    """Words the network puts into column p (weight 2^p) itself: K // 5
    shifted copies of the three planes of the five-sum, K % 5 single
    mismatch words."""
    return K // 5 + K % 5 if p == 0 else K // 5 if p < 3 else 0


def entries(K, p):
    """Words column p holds: its own and the carries of column p - 1."""
    return direct(K, 0) if p == 0 else direct(K, p) + entries(K, p - 1) // 2


def planes(K):
    return max(1, int(K).bit_length())


def column(K, p, e):
    """Adds column p's words: full adders on three at a time, a half adder
    on a last pair, carries into column p + 1. The top plane of a sum
    <= K never carries, so it only XORs."""
    n, top, up = entries(K, p), p == planes(K) - 1, direct(K, p + 1)
    if n == 0 or p >= planes(K):      # planes past the top one are zero
        return U(0)
    acc = e[p][0]
    for i in range(1, n, 2):
        if i + 1 < n:
            x, y = e[p][i], e[p][i + 1]
            if not top:
                e[p + 1][up + i // 2] = maj(acc, x, y)
            acc = xor3(acc, x, y)
        else:
            x = e[p][i]
            if not top:
                e[p + 1][up + i // 2] = gate(acc & x)
            acc = gate(acc ^ x)
    return acc


def window_sums(K, s5lo, s5hi, m_lo, m_hi):
    """Five planes c0..c4: bit b of cp is bit p of sum_{k<K} m[b + k],
    where m is the 64 mismatch bits (m_hi:m_lo), s5lo / s5hi the planes of
    m[j] + ... + m[j + 4] at positions 0-31 and 32-63."""
    q, r = divmod(K, 5)
    e = [[None] * 8 for _ in range(6)]
    for t in range(q):
        for p in range(3):
            e[p][t] = fsr(s5lo[p], s5hi[p], 5 * t)
    for j in range(r):
        e[0][q + j] = fsr(m_lo, m_hi, 5 * q + j)
    return [column(K, p, e) for p in range(5)]


def slice_min(mn, c, v):
    """mn = v and c < mn ? c : mn, per bit position: the borrow of c - mn
    from plane 0 up (one majority a plane), gated by v, then one select a
    plane. Equal is not less."""
    bw = gate(~c[0] & mn[0])
    for p in range(1, 5):
        bw = maj(~c[p], mn[p], bw)
    lt = gate(bw & v)
    return [gate((lt & c[p]) | (~lt & mn[p])) for p in range(5)]


def unpack(mn):
    """The 32 minima of a word's planes; BIG where no pair counted."""
    val = sum(((np.asarray(mn[p], U)[..., None] >> np.arange(32, dtype=U))
               & U(1)).astype(np.int64) << p for p in range(5))
    return np.where(val == NONE, BIG, val)


def step(K, o, p, s, mn, nw):
    """One offset: lanes score their nw own words against the partner words
    p[0..nw + 1] shifted by s, and fold into mn."""
    q = K // 5
    m = [gate(o[j]["b0"] ^ fsr(p[j]["b0"], p[j + 1]["b0"], s))
         for j in range(nw + 1)]
    m = [gate(m[j] | (o[j]["b1"] ^ fsr(p[j]["b1"], p[j + 1]["b1"], s)))
         for j in range(nw + 1)]
    m = [gate(m[j] | (o[j]["b2"] ^ fsr(p[j]["b2"], p[j + 1]["b2"], s)))
         for j in range(nw + 1)]
    s5 = [[U(0)] * 3 for _ in range(nw + 1)]
    if q >= 1:
        for j in range(nw):
            s5[j] = five(m[j], *(fsr(m[j], m[j + 1], k) for k in (1, 2, 3, 4)))
    if q >= 2:     # only its low 20 positions are read: plain shifts do
        s5[nw] = five(m[nw], *(shr(m[nw], k) for k in (1, 2, 3, 4)))
    for j in range(nw):
        v = gate(o[j]["ok"] & fsr(p[j]["ok"], p[j + 1]["ok"], s))
        c = window_sums(K, s5[j], s5[j + 1], m[j], m[j + 1])
        mn[j] = slice_min(mn[j], c, v)


def sweep_block(own, own_lim, part, part_lim, K, d_lo, d_hi, span0, bx, by,
                out, nw, span, warps, skip=True):
    """One block: own tile `by` against the offsets of span `bx`; returns
    the steps its warps made. `skip=False` makes every step, as a kernel
    without the 32-offset skip would."""
    words = 32 * nw
    tile = 32 * words
    part_words = words + span // 32 + 1
    base = by * tile
    d0 = span0 + bx * span
    lo = max(d_lo, d0)
    hi = min(d0 + span, d_hi, part_lim - K - base + 1)
    if lo >= hi:
        return 0
    s_own = stage(own, own_lim, base, words + 1, K)
    s_part = stage(part, part_lim, base + d0, part_words, K)
    lane = np.arange(32)
    o = [{f: a[nw * lane + j] for f, a in s_own.items()}
         for j in range(nw + 1)]
    dd_lo, dd_hi = lo - d0, hi - d0
    per = -(-(dd_hi - dd_lo) // warps)
    s_mn = np.empty((warps, 5, words), U)
    steps = 0
    for warp in range(warps):
        mn = [[np.full(32, ONES, U) for _ in range(5)] for _ in range(nw)]
        dd = dd_lo + warp * per
        dd_end = min(dd + per, dd_hi)
        while dd < dd_end:
            qq = dd >> 5
            s_end = min(32, dd_end - 32 * qq)
            p = [{f: a[nw * lane + qq + j] for f, a in s_part.items()}
                 for j in range(nw + 2)]
            # a pair of own word j is valid only where o[j].ok meets a bit
            # of p[j + 1].ok : p[j].ok shifted by s: for no s while either
            # is zero
            reach = np.zeros(32, bool)
            for j in range(nw):
                reach |= (o[j]["ok"] != 0) & ((p[j]["ok"] | p[j + 1]["ok"]) != 0)
            if reach.any() or not skip:   # else no lane has a valid pair
                for s in range(dd & 31, s_end):
                    step(K, o, p, s, mn, nw)
                    steps += 1
            dd = 32 * qq + s_end
        for j in range(nw):
            for pl in range(5):
                s_mn[warp, pl, nw * lane + j] = mn[j][pl]
    r = [s_mn[0, pl] for pl in range(5)]
    for warp in range(1, warps):
        r = slice_min(r, [s_mn[warp, pl] for pl in range(5)], ONES)
    got = unpack(r).reshape(-1)            # [words * 32]: start base + t
    seen = got < BIG
    t = base + np.nonzero(seen)[0]
    out[t] = np.minimum(out[t], got[seen])
    Ops.steps += steps
    return steps


def sweep_model(own, part, *, K, G_valid, d_lo, d_hi=None, nw=LANE_WORDS,
                span=SPAN, warps=WARPS, skip=True):
    """The wrapper's launch arguments, `sweep_launch`'s grid and every
    block of it. Adds the steps made to `Ops.steps`."""
    G = len(own)
    out = np.full(G, BIG, np.int64)
    n_win = G_valid - K + 1
    d_end = n_win if d_hi is None else min(d_hi, n_win)
    if d_lo >= d_end:
        return out
    own_lim, part_lim = G_valid, min(len(part), G_valid)
    tile = 32 * 32 * nw
    span0 = d_lo - d_lo % span
    for by in range(-(-n_win // tile)):
        for bx in range(-(-(d_end - span0) // span)):
            sweep_block(own, own_lim, part, part_lim, K, d_lo, d_end, span0,
                        bx, by, out, nw, span, warps, skip)
    return out


def _genome(n, seed, n_runs=2):
    """Codes with repeats (distance 0 and 1), N runs, single Ns, sentinels
    mid-array (EOS) and EOG at the end."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 2:n // 2 + 70] = g[30:100]              # a repeat
    g[n // 2 + 25] = (g[n // 2 + 25] + 1) % 4
    for _ in range(n_runs):
        a = int(rng.integers(0, n - 40))
        g[a:a + int(rng.integers(2, 40))] = 4      # an N run
    g[rng.integers(0, n, 5)] = 4
    g[n // 3] = 7                                  # EOS
    g[2 * n // 3 + 5] = 7
    g[-1] = 0x0F                                   # EOG
    return g


def _revcomp(g):
    return np.where(g[::-1] < 4, 3 - g[::-1], g[::-1]).astype(np.uint8)


def _plain(own, part, **kw):
    return sweep_plain(torch.from_numpy(own), torch.from_numpy(part),
                       **kw).numpy()


# --- the window-sum network ---------------------------------------------

@pytest.mark.parametrize("K", range(1, 26))
def test_window_sums_count_every_window(K):
    # 2,000 random 64-bit inputs, 32 windows each, against a direct count;
    # among them all-zero, all-one and sparse words
    rng = np.random.default_rng(K)
    m = rng.integers(0, 2**32, (2, 2000), dtype=np.uint64).astype(U)
    m[:, 0], m[:, 1] = 0, ONES
    m[:, 2:400] &= rng.integers(0, 2**32, (2, 398), dtype=np.uint64).astype(U)
    m_lo, m_hi = m
    zero = np.zeros_like(m_lo)
    s5lo = five(m_lo, *(fsr(m_lo, m_hi, k) for k in (1, 2, 3, 4)))
    s5hi = five(m_hi, *(shr(m_hi, k) for k in (1, 2, 3, 4)))
    if K < 10:       # the kernel builds s5hi only from K = 10 on
        s5hi = [zero] * 3
    c = window_sums(K, s5lo, s5hi, m_lo, m_hi)
    got = sum(((np.broadcast_to(c[p], m_lo.shape)[:, None]
                 >> np.arange(32, dtype=U)) & U(1)).astype(np.int64) << p
              for p in range(5))
    bits = ((m_lo[:, None] >> np.arange(32, dtype=U)) & U(1)).astype(np.int64)
    bits = np.concatenate(
        [bits, (m_hi[:, None] >> np.arange(32, dtype=U)) & U(1)], axis=1)
    want = np.lib.stride_tricks.sliding_window_view(bits, K, axis=1)[
        :, :32].sum(2)
    np.testing.assert_array_equal(got, want)
    assert want.max() == K and all(
        np.all(c[p] == 0) for p in range(planes(K), 5))


def test_window_sums_of_25_take_55_shifts_and_gates():
    m_lo = m_hi = np.zeros(4, U)
    Ops.n = 0
    s5lo = five(m_lo, *(fsr(m_lo, m_hi, k) for k in (1, 2, 3, 4)))
    s5hi = five(m_hi, *(shr(m_hi, k) for k in (1, 2, 3, 4)))
    window_sums(25, s5lo, s5hi, m_lo, m_hi)
    assert Ops.n == 55


@pytest.mark.parametrize("K", range(1, 26))
def test_ops_per_step_is_what_the_model_executes(K):
    zero = {f: np.zeros(32, U) for f in ("b0", "b1", "b2", "ok")}
    for nw in (1, 2, 4):
        mn = [[np.full(32, ONES, U)] * 5 for _ in range(nw)]
        Ops.n = 0
        step(K, [zero] * (nw + 1), [zero] * (nw + 2), 3, mn, nw)
        assert Ops.n == time_sweep.ops_per_step(K, nw)
    assert time_sweep.LANE_WORDS == LANE_WORDS


# --- the sliced minimum and the unpacking ---------------------------------

def test_slice_min_and_unpack_keep_the_least_valid_count():
    rng = np.random.default_rng(3)
    n, rounds = 64, 40
    mn = [np.full(n, ONES, U) for _ in range(5)]
    want = np.full((n, 32), BIG, np.int64)
    np.testing.assert_array_equal(unpack(mn), want)     # nothing seen
    for _ in range(rounds):
        val = rng.integers(0, 26, (n, 32))
        tie = (rng.random((n, 32)) < 0.2) & (want < BIG)
        val = np.where(tie, want, val)                   # equal is not less
        valid = rng.random((n, 32)) < 0.05
        c = [np.packbits(((val >> p) & 1).astype(np.uint8), axis=1,
                         bitorder="little").view("<u4").reshape(-1)
             for p in range(5)]
        v = np.packbits(valid.astype(np.uint8), axis=1,
                        bitorder="little").view("<u4").reshape(-1)
        mn = slice_min(mn, c, v)
        want = np.where(valid, np.minimum(want, val), want)
        np.testing.assert_array_equal(unpack(mn), want)
    assert (want == BIG).any() and (want < BIG).any()


# --- the staged planes ------------------------------------------------------

@pytest.mark.parametrize("K", [1, 7, 25])
def test_stage_words_hold_the_codes_and_the_window_validity(K):
    g = _genome(700, seed=K)
    lim, p0, nw = 650, 96, 21          # the last words reach past lim
    w = stage(g, lim, p0, nw, K)
    pos = p0 + np.arange(32 * nw)
    code = np.where(pos < lim, g[np.minimum(pos, len(g) - 1)], 0x0F)
    ext = np.concatenate([g[:lim], np.full(32 * nw + K + p0, 0x0F, np.uint8)])
    ok = np.array([(ext[a:a + K] < 5).all() for a in pos])
    for f, want in (("b0", code & 1), ("b1", (code >> 1) & 1),
                    ("b2", (code >> 2) & 1), ("ok", ok)):
        got = (w[f][:, None] >> np.arange(32, dtype=U)) & U(1)
        np.testing.assert_array_equal(got.reshape(-1), want.astype(U))


# --- the whole launch -------------------------------------------------------

@pytest.mark.parametrize("K", range(1, 26))
def test_model_matches_plain_at_every_k(K):
    # spans of 64 offsets and 2 warps: two tiles of 1,024 starts (one of
    # 2,048 at even K), many spans, ragged last words, the triangle's edge,
    # both strands
    g = _genome(1300, seed=100 + K)
    geo = dict(nw=1 if K % 2 else 2, span=64, warps=2)
    for own, part, d_lo in ((g, _revcomp(g), 0), (g, g, 1)):
        kw = dict(K=K, G_valid=len(g), d_lo=d_lo)
        want = _plain(own, part, **kw)
        np.testing.assert_array_equal(sweep_model(own, part, **kw, **geo),
                                      want)
    assert want.min() <= 1 and (want == BIG).any()    # the sense sweep


# (label, G, K, G_valid, partner length or "self"/"rc", d_lo, d_hi, geometry)
CASES = [
    ("the kernel's geometry, sense", 2300, 25, 2300, "self", 1, None, {}),
    ("the kernel's geometry, antisense, slice over a span boundary", 4300,
     25, 4300, "rc", 2040, 2060, {}),
    ("the kernel's geometry, K 13, G_valid < G", 2200, 13, 2150, "self", 1,
     300, {}),
    ("G_valid < G", 900, 25, 830, "self", 1, None,
     dict(nw=2, span=128, warps=4)),
    ("partner shorter than own", 800, 7, 800, 500, 0, None,
     dict(nw=1, span=64, warps=3)),
    ("slice inside one span", 900, 25, 900, "self", 70, 100,
     dict(nw=1, span=64, warps=8)),
    ("slice from a span's middle over three spans", 900, 24, 900, "rc", 100,
     300, dict(nw=2, span=64, warps=4)),
    ("slice that ends at G - K", 900, 25, 900, "self", 700, None,
     dict(nw=1, span=64, warps=2)),
    ("d_hi past the last window", 600, 5, 600, "self", 1, 5000,
     dict(nw=1, span=256, warps=8)),
    ("fewer offsets than warps", 600, 25, 600, "self", 3, 8,
     dict(nw=2, span=64, warps=8)),
    ("G a multiple of the tile", 1024, 10, 1024, "self", 1, None,
     dict(nw=1, span=1024, warps=8)),
    ("G one past a tile", 1025, 20, 1025, "rc", 0, None,
     dict(nw=1, span=512, warps=8)),
    ("four words a lane", 1500, 25, 1500, "self", 1, 400,
     dict(nw=4, span=128, warps=4)),
    ("long N runs: whole words without a valid window", 1200, 15, 1200,
     "self", 1, None, dict(nw=1, span=64, warps=2)),
]


@pytest.mark.parametrize("label,G,K,G_valid,partner,d_lo,d_hi,geo", CASES,
                         ids=[c[0] for c in CASES])
def test_model_matches_plain(label, G, K, G_valid, partner, d_lo, d_hi, geo):
    own = _genome(G, seed=G + K)
    if label.startswith("long N runs"):
        own[200:420] = 4
        own[700:800] = 7
    part = own if partner == "self" else _revcomp(own) if partner == "rc" \
        else _genome(partner, seed=G)
    kw = dict(K=K, G_valid=G_valid, d_lo=d_lo, d_hi=d_hi)
    want = _plain(own, part, **kw)
    np.testing.assert_array_equal(sweep_model(own, part, **kw, **geo), want)
    assert (want < BIG).any()


# --- sparse validity: what the 32-offset skip must not drop ----------------

def _acgt(n, seed):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _contigs(n, seed, lo, hi):
    """ACGT cut by an EOS every lo..hi positions."""
    rng = np.random.default_rng(seed)
    g = _acgt(n, seed + 1)
    at = np.cumsum(rng.integers(lo, hi + 1, n // lo))
    g[at[at < n]] = 7
    return g


def _only(n, seed, keep):
    """Sentinels everywhere but at the positions `keep` selects."""
    g = np.full(n, 7, np.uint8)
    g[keep] = _acgt(n, seed)[keep]
    return g


def sparse_inputs(label):
    """(own, part, K, d_lo, geometry) of a sparse-validity case."""
    pos = np.arange(9000)
    if label == "own starts 0-3 and 29-39, partner starts 10-14 of 64":
        own, part = _acgt(64, 1), _acgt(64, 2)
        part[10:35] = own[:25]    # the window pair (0, 10) is a near match
        part[12] = (part[12] + 1) % 4
        own[28] = part[9] = part[39] = 7
        return own, part, 25, 0, {}
    if label == "own valid at bits 0-3, partner at bits 16-19 of every word":
        return (_only(2000, 3, pos[:2000] % 32 < 8),
                _only(2000, 4, (pos[:2000] % 32 >= 16) & (pos[:2000] % 32 < 24)),
                5, 0, dict(nw=2, span=128, warps=3))
    if label == "an EOS every 20-40 bp on both strands, K 7":
        return (_contigs(3000, 5, 20, 40), _contigs(3000, 6, 20, 40), 7, 0,
                dict(nw=1, span=64, warps=2))
    if label == "an EOS every 20-40 bp on both strands, K 13, one tile":
        return _contigs(2500, 7, 20, 40), _contigs(2500, 8, 20, 40), 13, 0, {}
    if label == "tiles of contigs under K, a few over":
        own, part = _contigs(2600, 9, 10, 24), _contigs(2600, 10, 10, 24)
        for g, at in ((own, (40, 1100, 2300)), (part, (700, 1500, 2450))):
            for a in at:
                g[a:a + 31] = _acgt(31, a)
        return own, part, 25, 0, dict(nw=1, span=128, warps=4)
    if label == "one live stretch in each strand, far apart":
        return (_only(6600, 11, pos[:6600] < 200),
                _only(6600, 12, (pos[:6600] >= 6000) & (pos[:6600] < 6300)),
                25, 5000, {})
    raise ValueError(label)


SPARSE = [
    # (label, whether the skip must save steps here)
    ("own starts 0-3 and 29-39, partner starts 10-14 of 64", False),
    ("own valid at bits 0-3, partner at bits 16-19 of every word", False),
    ("an EOS every 20-40 bp on both strands, K 7", False),
    ("an EOS every 20-40 bp on both strands, K 13, one tile", False),
    ("tiles of contigs under K, a few over", True),
    ("one live stretch in each strand, far apart", True),
]


@pytest.mark.parametrize("label,fewer", SPARSE, ids=[c[0] for c in SPARSE])
def test_model_matches_plain_on_sparse_validity(label, fewer):
    own, part, K, d_lo, geo = sparse_inputs(label)
    kw = dict(K=K, G_valid=len(own), d_lo=d_lo)
    want = _plain(own, part, **kw)
    assert (want < BIG).any() and (want == BIG).any()
    steps = {}
    for skip in (True, False):
        Ops.steps = 0
        np.testing.assert_array_equal(
            sweep_model(own, part, **kw, **geo, skip=skip), want)
        steps[skip] = Ops.steps
    assert 0 < steps[True] <= steps[False]
    if fewer:
        assert steps[True] < steps[False] // 2


def test_skip_keeps_a_pair_whose_valid_bits_do_not_line_up():
    # own start 0 (bit 0) pairs with partner start 10 (bit 10) at offset 10:
    # the only partner starts are 10-14, and no own start has those bits
    own, part, K, d_lo, geo = sparse_inputs(SPARSE[0][0])
    want = _plain(own, part, K=K, G_valid=64, d_lo=d_lo)
    assert want[0] == 1 and (want[:4] < BIG).all() and (want[4:29] == BIG).all()
    got = sweep_model(own, part, K=K, G_valid=64, d_lo=d_lo)
    np.testing.assert_array_equal(got, want)


def test_model_constants_are_the_kernels():
    import re
    from pathlib import Path
    src = (Path(time_sweep.__file__).parents[1] / "csrc" / "sweep.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kLaneWords|kSpan|kWarps|kNone) = (\d+);", src)}
    assert const == {"kLaneWords": LANE_WORDS, "kSpan": SPAN, "kWarps": WARPS,
                     "kNone": NONE}
    assert time_sweep.LANE_WORDS == const["kLaneWords"]


def test_blocks_past_the_triangle_do_no_step():
    g = _genome(2600, seed=9)
    out = np.full(2600, BIG, np.int64)
    kw = dict(nw=1, span=64, warps=2)
    # own tile 2 (starts 2048..) against span 9 (offsets 576..639): every
    # partner window would start past the array's end
    assert sweep_block(g, 2600, g, 2600, 25, 1, 2576, 0, 9, 2, out, **kw) == 0
    assert (out == BIG).all()
    assert sweep_block(g, 2600, g, 2600, 25, 1, 2576, 0, 0, 2, out, **kw) > 0
    assert (out[2048:] < BIG).any() and (out[:2048] == BIG).all()
