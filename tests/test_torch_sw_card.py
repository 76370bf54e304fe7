"""The banded Smith-Waterman kernels (csrc/sw.cu) on the card: each held to
its plain PyTorch version (kernels/sw.py) on the engine's edge cases of
`make_pacbio_golden.sw_cases()`, the whole [Lp, B, W] pointer array and
every output equal, pad rows, band edges, ties and the bands of every
kernel instantiation included; the port on CUDA against the committed JAX
golden (kit4b_tpu_torch/data/pacbio_golden.npz); and the wrappers'
refusals. This file imports no jax, so on a machine with a card it runs
without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_sw_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.tools import make_pacbio_golden as mg

CASES = {c["label"]: c for c in mg.sw_cases()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(case, dev):
    probes, targets = mg.padded(case)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        probes, targets, case["plens"], case["tlens"], case["diag0"])]


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CASES))
def test_kernels_match_plain(cuda, label):
    case = CASES[label]
    p, t, pl, tl, d0 = _inputs(case, cuda)
    m, mm, go, ge = case["scores"]
    W = case["band"]
    kw = dict(W=W, match=m, mismatch=mm, gap_open=go, gap_ext=ge,
              traceback=case["traceback"])
    n0 = sw.sw_scan.launches
    got = sw.sw_scan(p, t, pl, tl, d0, **kw)
    want = sw.sw_scan_plain(p, t, pl, tl, d0, **kw)
    torch.cuda.synchronize()
    assert sw.sw_scan.launches == n0 + 1
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    if not case["traceback"]:
        return
    best, bi, bk, ptrs = want
    L_OPS = p.shape[1] + W
    for lim in (L_OPS, 37):             # the walk cut short too
        got = sw.sw_traceback(ptrs, p, t, best, bi, bk, d0, W=W, L_OPS=lim)
        want = sw.traceback_plain(ptrs, p, t, best, bi, bk, d0, W=W,
                                  L_OPS=lim)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_port_on_card_matches_golden(cuda):
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as gold:
        assert mg.inputs_sha256(mg.sw_cases(), mg.workload()) == \
            str(gold["inputs_sha256"])
        out = mg.compute(mg.port_fns(cuda))
        assert mg.differing(out, gold) == []


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    case = CASES["oracle"]
    p, t, pl, tl, d0 = _inputs(case, cuda)
    kw = dict(W=128, match=1, mismatch=-1, gap_open=-3, gap_ext=-1)
    with pytest.raises(ValueError, match="int32"):
        sw.sw_scan(p, t, pl.long(), tl, d0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        sw.sw_scan(p[:, ::2], t, pl, tl, d0, **kw)
    with pytest.raises(ValueError, match="band"):
        sw.sw_scan(p, t, pl, tl, d0, **{**kw, "W": sw.MAX_W + 1})
    with pytest.raises(ValueError, match="on"):
        sw.sw_scan(p, t.cpu(), pl, tl, d0, **kw)
    best, bi, bk, ptrs = sw.sw_scan(p, t, pl, tl, d0, **kw)
    with pytest.raises(ValueError, match="pointer bytes"):
        sw.sw_traceback(ptrs, p, t, best, bi, bk, d0, W=64, L_OPS=8)
