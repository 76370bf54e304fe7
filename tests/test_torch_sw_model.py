"""A numpy model of csrc/sw.cu's cluster scan and tiled traceback, held to
the plain PyTorch versions of kernels/sw.py on the cases of
kit4b_tpu_torch/tools/sw_cluster_cases.py.

The scan kernel spreads a pair over a cluster of P blocks whose warps own
32 x C consecutive band columns each (`sw.scan_layout`). A row: each thread
computes E, H0 and X of its C columns from registers and the next column's
carried H and E; each warp publishes one slot {max X, last X, first H0,
first E} into every block of the pair (lane r into block r: st.async on
block r's mbarrier, or shared memory and the block's barrier when P is
1), runs its own exclusive max scan of X with shuffles and writes the
previous row's bytes and best cells while the slots travel, then reads
slot `lane` of its own block and takes the maximum of X of the warps to
its left with one reduction; then F, H and the pointer bytes, and the
next row's up neighbour of the thread's last column, max(next H0, running
max + offset). Each thread keeps its own best cell (strictly greater only)
and the cluster reduces them at the end. `scan_model` does those steps on
numpy arrays over [B, threads, C], the shuffles with their rules (a lane
whose source is out of range keeps its own value), the slots per block
rank and row parity, and the idle columns past W - 1 as the kernel keeps
them (NEG once a row is done), so that a slip in the exchange, the
carried neighbour, the tie rule or the tail shows here on the CPU.

`traceback_model` is the kernel's walk: tiles of 32 rows x 128 band
columns staged as 33 aligned 4-byte words a row (zero past the array's
end) with each row's shift from its offset, the prefetch of the 32 rows
below, the switch to it or a restage where the walk stands, the table of
folded steps (`walk_step`, csrc/sw.cu's walk_entry without the tile move),
and the warp's count of matches and mismatches from the ops with ballots.
It also records how each tile was left and how each walk ended, so the
tests can show that the cases reach every path.

This file imports no jax:

    python -m pytest --noconftest tests/test_torch_sw_model.py
"""
import functools

import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.kernels.sw import NEG, sw_scan_plain, traceback_plain
from kit4b_tpu_torch.tools.sw_cluster_cases import cluster_cases, \
    random_pointer_cases

SMS = 132            # an H100's SMs, as scan_layout reads them on the card
TILE_ROWS, TILE_COLS = 32, 128
TILE_WORDS = TILE_COLS // 4 + 1
TILE_STRIDE = 4 * TILE_WORDS
TILE_BYTES = TILE_ROWS * TILE_STRIDE


def walk_step(state: int, byte: int) -> int:
    """csrc/sw.cu's walk_step: next | op << 2 | stop << 4 for state * 32 +
    byte, the folded steps of the walk."""
    d = byte & 3
    if state == 0:
        state = 3 if byte & 4 else 1
    if state == 1 and d == 2:
        state = 2
    if state == 1:
        return (4 if d == 1 else 0) | (16 if d == 0 else 0)
    if state == 2:
        return (2 if byte & 8 else 0) | 2 << 2
    return (3 if byte & 16 else 1) | 3 << 2


WALK_TABLE = [walk_step(t >> 5, t & 31) for t in range(128)]


def shfl_up(v: np.ndarray, o: int) -> np.ndarray:
    """__shfl_up_sync across each warp of the [..., threads] array `v`."""
    w = v.reshape(*v.shape[:-1], -1, 32)
    out = w.copy()
    out[..., o:] = w[..., :-o]
    return out.reshape(v.shape)


def shfl_down(v: np.ndarray, o: int) -> np.ndarray:
    w = v.reshape(*v.shape[:-1], -1, 32)
    out = w.copy()
    out[..., :-o] = w[..., o:]
    return out.reshape(v.shape)


def shfl_lane(v: np.ndarray, src: np.ndarray) -> np.ndarray:
    """__shfl_sync(v, src) with a source lane src[warp] for each warp."""
    w = v.reshape(*v.shape[:-1], -1, 32)
    got = w[..., np.arange(w.shape[-2]), src]
    return np.broadcast_to(got[..., None], w.shape).reshape(v.shape)


def warp_reduce_max(v: np.ndarray) -> np.ndarray:
    """__reduce_max_sync: every lane gets its warp's maximum."""
    w = v.reshape(*v.shape[:-1], -1, 32)
    return np.broadcast_to(w.max(-1, keepdims=True), w.shape) \
        .reshape(v.shape)


def lex_reduce(v, i, k):
    """The kernel's shuffle-down reduction of (value, row, column): lane 0
    of each warp ends with the largest value, then least row, then least
    column."""
    for o in (16, 8, 4, 2, 1):
        v2, i2, k2 = shfl_down(v, o), shfl_down(i, o), shfl_down(k, o)
        take = (v2 > v) | ((v2 == v) & ((i2 < i) | ((i2 == i) & (k2 < k))))
        v, i, k = (np.where(take, a, b) for a, b in ((v2, v), (i2, i),
                                                     (k2, k)))
    return v, i, k


def scan_model(probes, targets, plens, tlens, diag0, W, scores,
               traceback=True, layout=None):
    """The scan kernel on numpy arrays: all B pairs at once, each on its
    cluster's P x (threads a block) threads."""
    m, mm, go, ge = scores
    B, Lp = probes.shape
    Lt = targets.shape[1]
    P, C = layout or sw.scan_layout(B, W, SMS)
    nwb = sw._block_threads(W, P, C) // 32
    nw = P * nwb
    T = nw * 32
    t = np.arange(T)
    lane, g = t % 32, t // 32
    rank = g // nwb
    k0 = t * C
    ks = k0[:, None] + np.arange(C)                      # [T, C]
    edge, tail = k0 + C >= W, k0 + C > W
    koff, xoff = ks * ge, go - (ks + 1) * ge
    i64 = np.int64
    H = np.broadcast_to(np.where(ks < W, 0, NEG), (B, T, C)).astype(i64)
    E = np.full((B, T, C), NEG, i64)
    Hn = np.broadcast_to(np.where(edge, NEG, 0), (B, T)).astype(i64)
    En = np.full((B, T), NEG, i64)
    base = diag0.astype(i64)[:, None] - W // 2 + k0[None, :]   # [B, T]
    tlen = tlens.astype(i64)[:, None, None]
    rows = np.arange(B)[:, None, None]

    def tcode(c):
        code = targets[rows, np.clip(c, 0, Lt - 1)].astype(i64)
        return np.where((c >= 0) & (c < tlen), code, 0xFF)
    tb = tcode(base[..., None] + np.arange(C))
    best = np.zeros((B, T), i64)
    bi = np.zeros((B, T), i64)
    bk = np.zeros((B, T), i64)
    slots = np.zeros((B, P, 2, 32, 4), i64)   # each block's shared memory
    ptrs = np.zeros((Lp, B, W), np.uint8) if traceback else None
    real = ks < W
    for i in range(Lp):
        par = i & 1
        pb = probes[:, i].astype(i64)
        row_ok = (i < plens) & (pb < 4)
        pbx = np.where(row_ok, pb, 0x100)[:, None, None]
        lim = np.where(row_ok, 4, 0)[:, None, None]
        hup = np.concatenate([H[..., 1:], Hn[..., None]], -1)
        eup = np.concatenate([E[..., 1:], En[..., None]], -1)
        sub = np.where(tb == pbx, m, np.where(tb < lim, mm, NEG))
        e_ext, e_open = eup + ge, hup + go
        Ec = np.maximum(e_ext, e_open)
        diag = H + sub
        H0 = np.maximum(np.maximum(diag, Ec), 0)
        byte = np.where(H0 == 0, 0, np.where(H0 == diag, 1, 2)) \
            | np.where(e_ext >= e_open, 8, 0)
        X = H0 + xoff
        tmax = X.max(-1)
        # the warp's slot, stored by lane r into block r
        slot = np.stack([warp_reduce_max(tmax),
                         shfl_lane(X[..., C - 1], np.full(nw, 31)),
                         shfl_lane(H0[..., 0], np.zeros(nw, int)),
                         shfl_lane(Ec[..., 0], np.zeros(nw, int))], -1)
        for r in range(P):
            src = (lane == r)
            slots[:, r, par, g[src]] = slot[:, src]
        # between arrive and wait: the warp's own scan and neighbours
        incl = tmax
        for o in (1, 2, 4, 8, 16):
            incl = np.where(lane >= o, np.maximum(incl, shfl_up(incl, o)),
                            incl)
        excl = shfl_up(incl, 1)
        prev_x = shfl_up(X[..., C - 1], 1)
        nh0, ne = shfl_down(H0[..., 0], 1), shfl_down(Ec[..., 0], 1)
        # after the wait: slot `lane` of the thread's own block
        sl = slots[:, rank, par, lane]                   # [B, T, 4]
        before = warp_reduce_max(np.where(lane < g, sl[..., 0], NEG))
        gw = np.arange(nw)
        left_x = shfl_lane(sl[..., 1], (gw + 31) & 31)
        right_h0 = shfl_lane(sl[..., 2], (gw + 1) & 31)
        right_e = shfl_lane(sl[..., 3], (gw + 1) & 31)
        excl = np.where(lane == 0, before, np.maximum(excl, before))
        prev_x = np.where(lane == 0, np.where(g > 0, left_x, NEG), prev_x)
        nh0 = np.where(lane == 31, right_h0, nh0)
        ne = np.where(lane == 31, right_e, ne)
        run, fext = excl, excl > prev_x
        for j in range(C):
            F = run + koff[:, j]
            byte[..., j] |= np.where(F > H0[..., j], 4, 0) \
                | np.where(fext, 16, 0)
            H[..., j] = np.maximum(H0[..., j], F)
            fext = ~(X[..., j] >= run)
            run = np.maximum(X[..., j], run)
        E = Ec
        if traceback:
            ptrs[i][:, ks[real]] = byte[:, real]
        Hn = np.where(edge, NEG, np.maximum(nh0, run + (k0 + C) * ge))
        En = np.where(edge, NEG, ne)
        idle = tail[:, None] & ~real
        H = np.where(idle, NEG, H)
        E = np.where(idle, NEG, E)
        for j in range(C):
            up = H[..., j] > best
            best = np.where(up, H[..., j], best)
            bi = np.where(up, i, bi)
            bk = np.where(up, ks[:, j], bk)
        tb = np.concatenate([tb[..., 1:],
                             tcode((base + i + 1 + C - 1)[..., None])], -1)
    v, ii, kk = lex_reduce(best, bi, bk)
    # each warp's lane 0 into block 0's peaks, then warp 0 of block 0
    pv = np.full((B, 32), -1, i64)
    pi = np.zeros((B, 32), i64)
    pk = np.zeros((B, 32), i64)
    pv[:, :nw], pi[:, :nw], pk[:, :nw] = v[:, ::32], ii[:, ::32], kk[:, ::32]
    v, ii, kk = lex_reduce(pv, pi, pk)
    i32 = np.int32
    return v[:, 0].astype(i32), ii[:, 0].astype(i32), kk[:, 0].astype(i32), \
        ptrs


def _stage(flat, top, k_lo, b, B, W):
    """A tile as cp.async leaves it: 32 rows of 33 aligned words from the
    offset of column k_lo of each row, zero outside [0, total)."""
    rows = top - np.arange(TILE_ROWS)
    a4 = ((rows * B + b) * W + k_lo) & ~3
    word = np.arange(TILE_WORDS)
    n = np.clip(len(flat) - (a4[:, None] + 4 * word), 0, 4)
    n[a4[:, None] + 4 * word < 0] = 0              # src-size 0: no read
    off = a4[:, None, None] + 4 * word[:, None] + np.arange(4)
    keep = np.arange(4) < n[..., None]
    return np.where(keep, flat[np.where(keep, off, 0)], 0).astype(
        np.uint8).reshape(-1)


def traceback_model(ptrs, probes, targets, best, bi, bk, diag0, W, L_OPS,
                    log=None):
    """The traceback kernel, one warp (pair) at a time. `log`, a dict,
    gathers the tiles' exits and the walks' ends."""
    Lp, B, _ = ptrs.shape
    Lq, Lt = probes.shape[1], targets.shape[1]
    flat = np.ascontiguousarray(ptrs).reshape(-1)
    bw3 = (B * W) & 3
    log = {} if log is None else log
    ops = np.zeros((B, L_OPS), np.int8)
    out = np.zeros((5, B), np.int32)

    def tile_at(top, k_lo, b):
        return (top, k_lo, ((top * B + b) * W + k_lo) & 3)

    def holds(t, i, k):
        return t[0] - TILE_ROWS < i <= t[0] and t[1] <= k < t[1] + TILE_COLS

    def note(key):
        log[key] = log.get(key, 0) + 1
    for b in range(B):
        d0, half = int(diag0[b]), W // 2
        i0 = int(bi[b])
        c0 = d0 + i0 + int(bk[b]) - half
        i, c, k = i0, c0, int(bk[b])
        state = n = 0
        stop = best[b] <= 0
        bufs = [None, None]
        cur = 0
        t = nxt = tile_at(-1, 0, b)
        pending = False
        while True:
            done = False
            while True:
                if stop or i < 0 or c < 0 or k < 0 or k >= W or n >= L_OPS:
                    done = True
                    note("end: best <= 0" if best[b] <= 0 and n == 0
                         and stop else "end: H0 == 0" if stop else
                         "end: i < 0" if i < 0 else "end: c < 0" if c < 0
                         else "end: k out of band" if k < 0 or k >= W
                         else "end: L_OPS")
                    break
                rr = t[0] - i
                x = rr * TILE_STRIDE + ((t[2] - rr * bw3) & 3) + k - t[1]
                byte = int(bufs[cur][min(max(x, 0), TILE_BYTES - 1)]) \
                    if bufs[cur] is not None else 0
                if not (0 <= rr < TILE_ROWS and t[1] <= k < t[1] + TILE_COLS):
                    if t[0] >= 0:
                        note("exit: bottom" if rr >= TILE_ROWS else
                             "exit: left" if k < t[1] else "exit: right")
                    break
                e = WALK_TABLE[state * 32 + byte]
                op, state, stop = (e >> 2) & 3, e & 3, bool(e & 16)
                ops[b, n] = op
                n += op != 0
                di, dc = (0x6 >> op) & 1, (0xA >> op) & 1
                i, c, k = i - di, c - dc, k + di - dc
            if done:
                break
            if pending and holds(nxt, i, k):
                note("tile: prefetched")
                cur ^= 1
                t = nxt
            else:
                note("tile: restaged")
                t = tile_at(i, k - TILE_COLS // 2, b)
                bufs[cur] = _stage(flat, t[0], t[1], b, B, W)
            nxt = tile_at(t[0] - TILE_ROWS, k - TILE_COLS // 2, b)
            pending = nxt[0] >= 0
            if pending:
                bufs[cur ^ 1] = _stage(flat, nxt[0], nxt[1], b, B, W)
        # the warp counts matches and mismatches, 32 ops at a time
        lane = np.arange(32)
        di = dc = nm = nmm = 0
        for j0 in range(0, n, 32):
            op = np.where(j0 + lane < n, ops[b, np.minimum(j0 + lane,
                                                           L_OPS - 1)], 0)
            mi, mc = (op == 1) | (op == 2), (op == 1) | (op == 3)
            ii = i0 - di - (np.cumsum(mi) - mi)
            cc = c0 - dc - (np.cumsum(mc) - mc)
            hit = probes[b, np.clip(ii, 0, Lq - 1)] \
                == targets[b, np.clip(cc, 0, Lt - 1)]
            nm += int(((op == 1) & hit).sum())
            nmm += int(((op == 1) & ~hit).sum())
            di, dc = di + int(mi.sum()), dc + int(mc.sum())
        out[:, b] = (n, i + 1, c + 1, nm, nmm)
    return (ops, *out)


CASES = {c["label"]: c for c in cluster_cases()}
TRACED = [k for k, c in CASES.items() if c["traceback"]]
RANDOM = {c["label"]: c for c in random_pointer_cases()}
LOG = {}             # the tiles' exits and the walks' ends of every model run


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' many small operations on one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case):
    """The case as the scan takes it, unpadded: the kernel runs every row
    it is given, so padding adds rows and nothing else."""
    return (case["probes"], case["targets"], case["plens"], case["tlens"],
            case["diag0"])


@functools.cache
def _plain_scan(label):
    case = CASES[label]
    m, mm, go, ge = case["scores"]
    return sw_scan_plain(*(torch.from_numpy(a) for a in _inputs(case)),
                         W=case["band"], match=m, mismatch=mm, gap_open=go,
                         gap_ext=ge, traceback=case["traceback"])


@pytest.mark.parametrize("label", list(CASES))
def test_scan_model_matches_plain(label):
    case = CASES[label]
    got = scan_model(*_inputs(case), case["band"], case["scores"],
                     case["traceback"])
    for g, w, name in zip(got, _plain_scan(label), ("best", "bi", "bk",
                                                    "ptrs")):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("layout", sw.scan_layouts(1500))
def test_scan_model_at_every_layout(layout):
    """Every (P, C) the kernel takes for one band, every cluster size 1-8
    among them, gives the plain scan's answer."""
    case = CASES["W 1500"]
    got = scan_model(*_inputs(case), case["band"], case["scores"],
                     layout=layout)
    for g, w in zip(got, _plain_scan("W 1500")):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("label", TRACED)
def test_traceback_model_matches_plain(label):
    case = CASES[label]
    probes, targets, _, _, diag0 = _inputs(case)
    W = case["band"]
    best, bi, bk, ptrs = _plain_scan(label)
    for L_OPS in (probes.shape[1] + W, 37):     # the walk cut short too
        want = traceback_plain(ptrs, torch.from_numpy(probes),
                               torch.from_numpy(targets), best, bi, bk,
                               torch.from_numpy(diag0), W=W, L_OPS=L_OPS)
        got = traceback_model(ptrs.numpy(), probes, targets, best.numpy(),
                              bi.numpy(), bk.numpy(), diag0, W, L_OPS, LOG)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("label", list(RANDOM))
def test_traceback_model_on_random_bytes(label):
    c = RANDOM[label]
    want = traceback_plain(*(torch.from_numpy(c[k]) for k in (
        "ptrs", "probes", "targets", "best", "bi", "bk", "diag0")),
        W=c["W"], L_OPS=c["L_OPS"])
    got = traceback_model(c["ptrs"], c["probes"], c["targets"], c["best"],
                          c["bi"], c["bk"], c["diag0"], c["W"], c["L_OPS"],
                          LOG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_cases_reach_every_path():
    """The cases run every cluster size and columns a thread, a thread
    with idle columns, a tie in one row across blocks, and walks that
    leave tiles through the bottom and the left side, enter prefetched
    tiles and end on every rule (the walks of the tests above, or run here
    where this test runs alone)."""
    layouts = {sw.scan_layout(c["probes"].shape[0], c["band"], SMS)
               for c in CASES.values()}
    assert {P for P, _ in layouts} == {1, 2, 3, 4, 8}   # the rest below
    assert {C for _, C in layouts} == set(sw.THREAD_COLS)
    assert any(c["band"] % sw.scan_layout(c["probes"].shape[0], c["band"],
                                          SMS)[1] for c in CASES.values())
    best, bi, bk, _ = _plain_scan("peak ties")
    assert best.tolist() == [60, 60] and bi.tolist() == [359, 159]
    assert bk.tolist() == [800, 1165]      # the tie at k 800 and 1,300
    if not LOG:
        for label in TRACED:
            test_traceback_model_matches_plain(label)
        for label in RANDOM:
            test_traceback_model_on_random_bytes(label)
    for key in ("exit: bottom", "exit: left", "tile: prefetched",
                "tile: restaged", "end: best <= 0", "end: H0 == 0",
                "end: i < 0", "end: c < 0", "end: k out of band",
                "end: L_OPS"):
        assert LOG.get(key, 0) > 0, (key, LOG)
    # a D run moves one column a row: a walk enters each tile at its top
    # row at most 32 columns right of the tile's centre and meets the
    # bottom, not the right side, 32 rows later (the D runs of "gap runs"
    # and of the random bytes above)
    assert "exit: right" not in LOG


@pytest.mark.parametrize("W", [1, 31, 32, 33, 256, 512, 600, 1024, 1025,
                               2048, 2049, 3000, 4096, 4097, 8192])
def test_layout_covers_every_band_width(W):
    """Every layout the kernel takes covers the band with at most 32 warps
    a pair and 512 threads a block, and scan_layout picks one for every
    batch size, keeping B x P blocks on the SMs."""
    fits = sw.scan_layouts(W)
    assert fits
    for P, C in fits:
        threads = sw._block_threads(W, P, C)
        assert threads % 32 == 0 and 32 <= threads <= sw.MAX_BLOCK_THREADS
        need = -(-W // (32 * C))          # warps that hold a column
        assert need <= P * threads // 32 < need + P <= sw.MAX_WARPS + P
        assert P * threads // 32 <= sw.MAX_WARPS
    for B in (1, 3, 16, 32, 33, 132, 200, 5000):
        P, C = sw.scan_layout(B, W, SMS)
        assert (P, C) in fits
        assert P == min(p for p, _ in fits) or (
            B * P <= SMS and W >= P * sw.MIN_BLOCK_COLS)


def test_build_paths_of_the_sw_kernels():
    """csrc/sw.cu builds like the other kernels: one library keyed by its
    source and nvcc's flags, for sm_90a."""
    from kit4b_tpu_torch.kernels import build
    src, lib, log = build.paths("sw")
    assert src == build.CSRC / "sw.cu" and src.is_file()
    assert lib.parent == log.parent == build.PKG / "_build"
    assert len(lib.stem.split("-")[-1]) == 16
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    text = src.read_text()
    for entry in ("sw_scan_launch", "sw_scan_clusters", "sw_traceback_launch",
                  "sw_cluster_probe"):
        assert f'extern "C" int {entry}(' in text
