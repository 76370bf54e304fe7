"""A numpy model of csrc/sw.cu's thread layout, held to the plain PyTorch
versions of kernels/sw.py on the engine's edge cases.

The scan kernel splits a row's W columns into runs of C consecutive columns
a thread (C = 1, 2, 4 or 8, the least that lets 1,024 threads cover W),
resolves F's max scan serially inside a run, then across the warp with
`__shfl_up_sync`, then across warps through shared memory, and finds the
row peak by a first-index (value, index) reduction with `__shfl_down_sync`
in each warp and then in warp 0. `scan_model` does the same steps on numpy
arrays, lane by lane with the shuffles' rules (a lane whose source is out
of range keeps its own value), so that a slip in the kernel's carries
across threads or warps, or in its tie rules, shows here on the CPU;
`traceback_model` is the kernel's walk, one lane at a time with its
`switch`. This file imports no jax:

    python -m pytest --noconftest tests/test_torch_sw_model.py
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kernels.sw import NEG, sw_scan_plain, traceback_plain
from kit4b_tpu_torch.tools import make_pacbio_golden as mg

INT32_MIN = np.iinfo(np.int32).min


def layout(W: int) -> tuple[int, int]:
    """(C, threads) of sw_scan_launch."""
    C = 1 if W <= 1024 else 2 if W <= 2048 else 4 if W <= 4096 else 8
    per_thread = -(-W // C)
    return C, -(-per_thread // 32) * 32


def shfl_up(v: np.ndarray, o: int) -> np.ndarray:
    """__shfl_up_sync across each warp of the [threads] vector `v`."""
    w = v.reshape(-1, 32)
    out = w.copy()
    out[:, o:] = w[:, :-o]
    return out.reshape(-1)


def shfl_down(v: np.ndarray, o: int) -> np.ndarray:
    w = v.reshape(-1, 32)
    out = w.copy()
    out[:, :-o] = w[:, o:]
    return out.reshape(-1)


def warp_inclusive_max(v: np.ndarray) -> np.ndarray:
    lane = np.arange(len(v)) % 32
    for o in (1, 2, 4, 8, 16):
        up = shfl_up(v, o)
        v = np.where(lane >= o, np.maximum(v, up), v)
    return v


def warp_first_max(v: np.ndarray, k: np.ndarray):
    """Lane 0 of each warp ends with the warp's first-index maximum."""
    for o in (16, 8, 4, 2, 1):
        v2, k2 = shfl_down(v, o), shfl_down(k, o)
        take = (v2 > v) | ((v2 == v) & (k2 < k))
        v, k = np.where(take, v2, v), np.where(take, k2, k)
    return v, k


def scan_model(probes, targets, plens, tlens, diag0, W, scores,
               traceback=True):
    """The scan kernel, block by block (one block a pair)."""
    m, mm, go, ge = scores
    B, Lp = probes.shape
    Lt = targets.shape[1]
    C, T = layout(W)
    nwarps = T // 32
    lane, warp = np.arange(T) % 32, np.arange(T) // 32
    ks = np.arange(T)[:, None] * C + np.arange(C)[None, :]     # [T, C]
    real = ks < W
    ptrs = np.zeros((Lp, B, W), np.uint8) if traceback else None
    best = np.zeros(B, np.int32)
    bi = np.zeros(B, np.int32)
    bk = np.zeros(B, np.int32)
    for b in range(B):
        Hs = np.zeros(W + 1, np.int64)
        Hs[W] = NEG
        Es = np.full(W + 1, NEG, np.int64)
        for i in range(Lp):
            pb = int(probes[b, i])
            row_ok = i < plens[b] and pb < 4
            kc = np.minimum(ks, W - 1)
            c = int(diag0[b]) - W // 2 + i + kc
            tb = targets[b, np.clip(c, 0, Lt - 1)].astype(np.int64)
            ok = real & row_ok & (c >= 0) & (c < tlens[b]) & (tb < 4)
            sub = np.where(ok, np.where(tb == pb, m, mm), NEG)
            e_open, e_ext = Hs[kc + 1] + go, Es[kc + 1] + ge
            E = np.maximum(e_open, e_ext)
            diag = Hs[kc] + sub
            H0 = np.maximum(np.maximum(diag, E), 0)
            bits = np.where(H0 == 0, 0, np.where(H0 == diag, 1, 2)) \
                | np.where(e_ext >= e_open, 8, 0)
            X = np.where(real, H0 + go - (kc + 1) * ge, NEG)
            tmax = X.max(1)
            last_x = np.array([X[t][real[t]][-1] if real[t].any() else NEG
                               for t in range(T)])
            incl = warp_inclusive_max(tmax)
            excl, prev_x = shfl_up(incl, 1), shfl_up(last_x, 1)
            wmax = incl.reshape(-1, 32)[:, 31]
            wlast = last_x.reshape(-1, 32)[:, 31]
            # every warp scans the warps' maxima across its lanes
            wv = np.full(32, NEG, np.int64)
            wv[:nwarps] = wmax
            wv = warp_inclusive_max(wv)
            before = wv[(warp + 31) % 32]
            excl = np.where(lane == 0, np.where(warp > 0, before, NEG),
                            np.where(warp > 0, np.maximum(excl, before),
                                     excl))
            prev_x = np.where(lane == 0, np.where(
                warp > 0, wlast[np.maximum(warp - 1, 0)], NEG), prev_x)
            pv = np.full(T, INT32_MIN, np.int64)
            pk = np.zeros(T, np.int64)
            run, px = excl.copy(), prev_x.copy()
            for j in range(C):
                k = ks[:, j]
                on = real[:, j]
                F = run + k * ge
                Hf = np.maximum(H0[:, j], F)
                byte = bits[:, j] | np.where(F > H0[:, j], 4, 0) \
                    | np.where(run > px, 16, 0)
                if traceback:
                    ptrs[i, b, k[on]] = byte[on]
                better = on & (Hf > pv)
                pv, pk = np.where(better, Hf, pv), np.where(better, k, pk)
                Hs[k[on]] = Hf[on]
                Es[k[on]] = E[on, j]
                run = np.where(on, np.maximum(run, X[:, j]), run)
                px = np.where(on, X[:, j], px)
            v, kk = warp_first_max(pv, pk)
            wv = np.full(32, INT32_MIN, np.int64)
            wk = np.zeros(32, np.int64)
            wv[:nwarps], wk[:nwarps] = v[::32], kk[::32]
            v, kk = warp_first_max(wv, wk)
            if v[0] > best[b]:
                best[b], bi[b], bk[b] = v[0], i, kk[0]
    return best, bi, bk, ptrs


def traceback_model(ptrs, probes, targets, best, bi, bk, diag0, W, L_OPS):
    """The traceback kernel's walk, one lane at a time."""
    Lp, B, _ = ptrs.shape
    Lq, Lt = probes.shape[1], targets.shape[1]
    ops = np.zeros((B, L_OPS), np.int8)
    out = np.zeros((5, B), np.int32)
    for b in range(B):
        d0, half = int(diag0[b]), W // 2
        i = int(bi[b])
        c = d0 + i + int(bk[b]) - half
        state = n = nm = nmm = 0
        stop = best[b] <= 0
        while True:
            k = c - i - d0 + half
            if stop or i < 0 or c < 0 or k < 0 or k >= W or n >= L_OPS:
                break
            byte = int(ptrs[min(i, Lp - 1), b, k])
            d, op = byte & 3, 0
            if state == 0:
                nxt = 3 if byte & 4 else 1
            elif state == 1:
                nxt = 0 if d == 1 else 2
                if d == 0:
                    stop = True
                elif d == 1:
                    op = 1
            elif state == 2:
                nxt, op = (2 if byte & 8 else 0), 2
            else:
                nxt, op = (3 if byte & 16 else 1), 3
            if op:
                if op == 1:
                    hit = probes[b, min(i, Lq - 1)] == targets[b, min(c, Lt - 1)]
                    nm, nmm = nm + hit, nmm + (not hit)
                ops[b, n] = op
                n += 1
                i -= op != 3
                c -= op != 2
            state = nxt
        out[:, b] = (n, i + 1, c + 1, nm, nmm)
    return (ops, *out)


# the kernel's four instantiations, a warp boundary on each side, and the
# cases whose edges the tie rules decide, at a few probe rows each
MODEL_CASES = ["oracle", "band edges", "equal peaks", "plen 0 lanes",
               "N and 0x0F codes", "scores tie", "W 1", "W 31", "W 1025",
               "W 3000", "W 4097", "L_OPS padded", "traceback=False"]
CASES = {c["label"]: c for c in mg.sw_cases()}


def _cut(case, rows):
    """The case's first `rows` probe columns (plens cut to match)."""
    probes, targets = mg.padded(case)
    return (probes[:, :rows].copy(), targets,
            np.minimum(case["plens"], rows), case["tlens"], case["diag0"])


@pytest.mark.parametrize("label", MODEL_CASES)
def test_scan_model_matches_plain(label):
    case = CASES[label]
    rows = 48 if case["band"] > 1000 else 160
    probes, targets, plens, tlens, diag0 = _cut(case, rows)
    W, tb = case["band"], case["traceback"]
    m, mm, go, ge = case["scores"]
    got = scan_model(probes, targets, plens, tlens, diag0, W,
                     case["scores"], tb)
    want = sw_scan_plain(*(torch.from_numpy(a) for a in (
        probes, targets, plens, tlens, diag0)), W=W, match=m, mismatch=mm,
        gap_open=go, gap_ext=ge, traceback=tb)
    for g, w, name in zip(got, want, ("best", "bi", "bk", "ptrs")):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


@pytest.mark.parametrize("label", [k for k in MODEL_CASES
                                   if CASES[k]["traceback"]])
def test_traceback_model_matches_plain(label):
    case = CASES[label]
    probes, targets = mg.padded(case)
    t = [torch.from_numpy(a) for a in (probes, targets, case["plens"],
                                       case["tlens"], case["diag0"])]
    m, mm, go, ge = case["scores"]
    W = case["band"]
    best, bi, bk, ptrs = sw_scan_plain(*t, W=W, match=m, mismatch=mm,
                                       gap_open=go, gap_ext=ge)
    for L_OPS in (probes.shape[1] + W, 37):     # the walk cut short too
        want = traceback_plain(ptrs, t[0], t[1], best, bi, bk, t[4], W=W,
                               L_OPS=L_OPS)
        got = traceback_model(ptrs.numpy(), probes, targets, best.numpy(),
                              bi.numpy(), bk.numpy(), case["diag0"], W,
                              L_OPS)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def test_layout_covers_every_band_width():
    for W in (1, 31, 32, 33, 1024, 1025, 2048, 2049, 4096, 4097, 8192):
        C, T = layout(W)
        assert T % 32 == 0 and T <= 1024 and C * T >= W > C * (T - 32)


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
    for entry in ("sw_scan_launch", "sw_traceback_launch"):
        assert f'extern "C" int {entry}(' in text
