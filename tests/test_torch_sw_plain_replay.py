"""The plain SW versions of kit4b_tpu_torch/kernels/sw.py, whose chunks of
rows and runs of CHECK_EVERY walk steps replay as captured CUDA graphs on
the card, held on the CPU to the loops as they stood before that change
(`scan_unchanged`, `traceback_unchanged` below, kept verbatim): the same
best cells, pointer bytes and walks on the PacBio golden's engine cases,
the random pointer bytes of tools/sw_cluster_cases.py, and pads of every
length around the chunk's CHUNK_ROWS rows, so that the scan's stop after
the last probe row falls at the start, the middle and the end of a chunk.
The graph capture itself runs only on the card (chip_smoke.py phases 15b
and 16b hold the kernels to these plain versions there)."""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.kernels.sw import (CHECK_EVERY, CHUNK_ROWS, NEG,
                                        _walk_tables)
from kit4b_tpu_torch.tools import make_pacbio_golden as mg
from kit4b_tpu_torch.tools.sw_cluster_cases import random_pointer_cases


def scan_unchanged(probes: torch.Tensor, targets: torch.Tensor,
                  plens: torch.Tensor, tlens: torch.Tensor,
                  diag0: torch.Tensor, *, W: int, match: int, mismatch: int,
                  gap_open: int, gap_ext: int, traceback: bool = True):
    """Plain PyTorch version of the scan kernel; its spec is `_sw_scan` of
    kit4b_tpu/pacbio/sswd.py. Returns (best, bi, bk) as [B] int32 and the
    [Lp, B, W] uint8 pointer bytes, or None without `traceback`.

    One row at a time, in chunks of CHUNK_ROWS rows: a chunk's target codes,
    cell rule and substitution scores are gathered at once, and its
    pointer bytes are packed at once from the rows' flags. H and E ride
    [B, W + 1] buffers whose last column stays NEG (the up neighbour past
    the band), and X rides one whose first column stays NEG, so that F's
    exclusive prefix maximum is one `cummax`. Once every lane is past its
    probe (no cell can match) and a row leaves the carried H and E as it
    found them, every later row repeats that row exactly: the rest of the
    pointer array is that row's bytes and the best cell does not move, so
    the loop stops there."""
    B, Lp = probes.shape
    Lt = targets.shape[1]
    dev = probes.device
    i32 = dict(dtype=torch.int32, device=dev)
    k = torch.arange(W, **i32)
    xoff = gap_open - (k + 1) * gap_ext       # X = H0 + xoff
    foff = k * gap_ext                         # F = Mx + foff
    base = diag0[:, None, None] + k[None, None, :] - W // 2
    score = (torch.tensor(match, **i32), torch.tensor(mismatch, **i32))
    neg = torch.tensor(NEG, **i32)
    Hb = torch.zeros((B, W + 1), **i32)        # H, then NEG
    Hb[:, W] = NEG
    Eb = torch.full((B, W + 1), NEG, **i32)    # E, then NEG
    Xb = torch.full((B, W + 1), NEG, **i32)    # NEG, then X
    H, Hup, Eup = Hb[:, :W], Hb[:, 1:], Eb[:, 1:]
    X, Xx = Xb[:, 1:], Xb[:, :W]
    best = torch.zeros(B, **i32)
    bi = torch.zeros(B, **i32)
    bk = torch.zeros(B, **i32)
    ptrs = torch.empty((Lp, B, W), dtype=torch.uint8, device=dev) \
        if traceback else None
    if traceback:
        R = min(CHUNK_ROWS, Lp)
        dirb = torch.empty((R, B, W), dtype=torch.uint8, device=dev)
        usedf, eext, fext = (torch.empty((R, B, W), dtype=torch.bool,
                                         device=dev) for _ in range(3))
    last_probe_row = int(plens.max()) if B else 0
    steady = False
    for i0 in range(0, Lp, CHUNK_ROWS):
        R = min(CHUNK_ROWS, Lp - i0)
        rows = torch.arange(i0, i0 + R, **i32)
        cols = base + rows[None, :, None]                      # [B, R, W]
        tb = torch.gather(targets, 1, cols.clamp(0, Lt - 1).view(B, -1)
                          .long()).view(B, R, W)
        pb = probes[:, i0:i0 + R, None]
        okp = (rows[None, :, None] < plens[:, None, None]) & (pb < 4) \
            & (cols >= 0) & (cols < tlens[:, None, None]) & (tb < 4)
        subs = torch.where(okp, torch.where(pb == tb, *score), neg)
        done = R
        for r in range(R):
            i = i0 + r
            e_open = Hup + gap_open
            e_ext = Eup + gap_ext
            E = torch.maximum(e_open, e_ext)
            diag = H + subs[:, r]
            H0 = torch.maximum(diag, E).clamp_(min=0)
            torch.add(H0, xoff, out=X)
            Mx = torch.cummax(Xb, 1).values[:, :W]
            F = Mx + foff
            Hf = torch.maximum(H0, F)
            rk = Hf.argmax(1).to(torch.int32)
            rb = Hf.amax(1)
            improve = rb > best
            best = torch.maximum(best, rb)
            bi.masked_fill_(improve, i)
            bk = torch.where(improve, rk, bk)
            if traceback:
                dirb[r] = torch.where(H0 == 0, 0,
                                      torch.where(H0 == diag, 1, 2))
                torch.gt(F, H0, out=usedf[r])
                torch.ge(e_ext, e_open, out=eext[r])
                torch.gt(Mx, Xx, out=fext[r])
            steady = i >= last_probe_row and torch.equal(Hf, H) \
                and torch.equal(E, Eb[:, :W])
            H.copy_(Hf)
            Eb[:, :W] = E
            if steady:
                done = r + 1
                break
        if traceback:
            ptrs[i0:i0 + done] = (dirb[:done] | (usedf[:done].to(torch.uint8)
                                                 << 2)
                                  | (eext[:done].to(torch.uint8) << 3)
                                  | (fext[:done].to(torch.uint8) << 4))
        if steady:
            if traceback:
                ptrs[i0 + done:] = ptrs[i0 + done - 1]
            break
    return best, bi, bk, ptrs


def traceback_unchanged(ptrs: torch.Tensor, probes: torch.Tensor,
                    targets: torch.Tensor, best: torch.Tensor,
                    bi: torch.Tensor, bk: torch.Tensor, diag0: torch.Tensor,
                    *, W: int, L_OPS: int):
    """Plain PyTorch version of the traceback kernel; its spec is
    `_traceback_dev` of kit4b_tpu/pacbio/sswd.py. Every lane steps in
    lockstep through `_walk_tables`, a lane that has stopped keeps its
    state, and the host reads whether any lane still walks every
    CHECK_EVERY steps. Returns ops ([B, L_OPS] int8), n, ps, ts, nm, nmm
    ([B] int32)."""
    Lp, B, _ = ptrs.shape
    Lq, Lt = probes.shape[1], targets.shape[1]
    dev = ptrs.device
    nxt, opc, stops = _walk_tables(dev)
    lanes = torch.arange(B, device=dev)
    d0 = diag0.long() - W // 2
    i = bi.long()
    c = d0 + i + bk.long()
    state = torch.zeros(B, dtype=torch.long, device=dev)
    n, nm, nmm = (torch.zeros(B, dtype=torch.long, device=dev)
                  for _ in range(3))
    ops = torch.zeros((B, L_OPS), dtype=torch.int8, device=dev)
    stop = best <= 0

    def walking():
        k = c - i - d0
        return ~stop & (i >= 0) & (c >= 0) & (k >= 0) & (k < W) \
            & (n < L_OPS)
    while bool(walking().any()):
        for _ in range(CHECK_EVERY):
            act = walking()
            k = (c - i - d0).clamp(0, W - 1)
            byte = ptrs[i.clamp(0, Lp - 1), lanes, k]
            t = state * 32 + byte
            op = opc[t]
            emit = act & (op > 0)
            m_op = emit & (op == 1)
            match = probes[lanes, i.clamp(0, Lq - 1)] \
                == targets[lanes, c.clamp(0, Lt - 1)]
            nm += m_op & match
            nmm += m_op & ~match
            slot = n.clamp(max=L_OPS - 1)[:, None]
            ops.scatter_(1, slot, torch.where(
                emit[:, None], op.to(torch.int8)[:, None],
                ops.gather(1, slot)))
            n += emit
            i -= (emit & (op != 3)).long()
            c -= (emit & (op != 2)).long()
            state = torch.where(act, nxt[t], state)
            stop = stop | (act & stops[t])
    i32 = torch.int32
    return (ops, n.to(i32), (i + 1).to(i32), (c + 1).to(i32), nm.to(i32),
            nmm.to(i32))


def _scan_inputs(case):
    """The scan's inputs: the golden's cases padded as banded_sw_batch
    pads them, the pad cases as they are."""
    pp, tp = (case["probes"], case["targets"]) if case["label"] in PADS \
        else mg.padded(case)
    m, mm, go, ge = case["scores"]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        pp, tp, case["plens"], case["tlens"], case["diag0"])]
    return args, dict(W=case["band"], match=m, mismatch=mm, gap_open=go,
                      gap_ext=ge)


# probe lengths of _pad_cases whose scans stop (no cell left to change) at
# row 63, 77 and 128 (of Lp 256) and 236; at Lp 64 and 100 the stop
# falls on the last row of the only chunk, or past the end
PAD_LPS = {38: (64, 256), 50: (256,), 83: (100, 256), 161: (256,)}


def _pad_cases():
    """Two pairs, a probe of n bases and its first half against a
    mutated copy, their probe rows padded to Lp: the scan's stop after the
    last probe row falls at the first, a middle and the last row of a
    chunk of CHUNK_ROWS, in a partial last chunk, or nowhere."""
    rng = np.random.default_rng(1616)
    out = []
    for n in range(20, max(PAD_LPS) + 1, 3):
        a = rng.integers(0, 4, n).astype(np.uint8)
        b = mg.mutate(rng, a)
        out += [mg._batch(f"n {n}, Lp {Lp}", [(a, b), (a[: n // 2], b)],
                          Lp, Lp + 64, [0, 3], 64)
                for Lp in PAD_LPS.get(n, ())]
    return out


PADS = {c["label"]: c for c in _pad_cases()}
# the golden's cases of bands up to 1,024: the chunks do not depend on W
CASES = {c["label"]: c for c in mg.sw_cases() if c["band"] <= 1024} | PADS


@pytest.mark.parametrize("label", list(CASES))
def test_scan_and_walk_equal_the_unchanged_loops(label):
    case = CASES[label]
    args, kw = _scan_inputs(case)
    scans = {}
    for traceback in (True, False):
        scans[traceback] = sw.sw_scan_plain(*args, traceback=traceback, **kw)
        want = scan_unchanged(*args, traceback=traceback, **kw)
        for g, w in zip(scans[traceback], want):
            assert (g is None and w is None) or torch.equal(g, w)
    best, bi, bk, ptrs = scans[True]
    p, t, _, _, d0 = args
    for L_OPS in (p.shape[1] + kw["W"], 37):
        got = sw.traceback_plain(ptrs, p, t, best, bi, bk, d0, W=kw["W"],
                                 L_OPS=L_OPS)
        want = traceback_unchanged(ptrs, p, t, best, bi, bk, d0,
                                   W=kw["W"], L_OPS=L_OPS)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", random_pointer_cases(),
                         ids=lambda c: c["label"])
def test_walks_on_random_bytes_equal_the_unchanged_loop(case):
    args = [torch.from_numpy(case[k]) for k in (
        "ptrs", "probes", "targets", "best", "bi", "bk", "diag0")]
    got = sw.traceback_plain(*args, W=case["W"], L_OPS=case["L_OPS"])
    want = traceback_unchanged(*args, W=case["W"], L_OPS=case["L_OPS"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
