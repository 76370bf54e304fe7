"""The banded Smith-Waterman kernels (csrc/sw.cu) on the card: each held to
its plain PyTorch version (kernels/sw.py) on the engine's edge cases of
`make_pacbio_golden.sw_cases()` and on the cases built to break the
cluster scan and the tiled walk (`tools/sw_cluster_cases.py`: every
cluster size, ties across blocks, gap runs across warp and block edges,
idle columns, every stop rule, random pointer bytes), the whole
[Lp, B, W] pointer array and every output equal; the scan at every layout
it takes for one band; the cluster's own costs; the port on CUDA against
the committed JAX golden (kit4b_tpu_torch/data/pacbio_golden.npz); and
the wrappers' refusals. This file imports no jax, so on a machine with a
card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_sw_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.tools import make_pacbio_golden as mg
from kit4b_tpu_torch.tools.sw_cluster_cases import cluster_cases, \
    random_pointer_cases

CASES = {c["label"]: c for c in mg.sw_cases()}
CLUSTER = {c["label"]: c for c in cluster_cases()}
RANDOM = {c["label"]: c for c in random_pointer_cases()}


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
    _kernels_match_plain(cuda, CASES[label])


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(CLUSTER))
def test_kernels_match_plain_on_cluster_cases(cuda, label):
    _kernels_match_plain(cuda, CLUSTER[label])


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(RANDOM))
def test_walk_matches_plain_on_random_bytes(cuda, label):
    c = RANDOM[label]
    args = [torch.from_numpy(c[k]).to(cuda) for k in (
        "ptrs", "probes", "targets", "best", "bi", "bk", "diag0")]
    for lim in (c["L_OPS"], 37):
        got = sw.sw_traceback(*args, W=c["W"], L_OPS=lim)
        want = sw.traceback_plain(*args, W=c["W"], L_OPS=lim)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_scan_at_every_layout(cuda):
    """Every (P, C) the kernel takes, every cluster size 1-8 among them,
    gives the same answer at W 1,500."""
    case = CLUSTER["W 1500"]
    p, t, pl, tl, d0 = _inputs(case, cuda)
    m, mm, go, ge = case["scores"]
    kw = dict(W=1500, match=m, mismatch=mm, gap_open=go, gap_ext=ge)
    want = sw.sw_scan_plain(p, t, pl, tl, d0, **kw)
    layouts = sw.scan_layouts(1500)
    assert len(layouts) > 4
    for layout in layouts:
        got = sw.sw_scan(p, t, pl, tl, d0, layout=layout, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), layout
        assert sw.scan_clusters(cuda, p.shape[0], 1500, layout) > 0


@pytest.mark.cuda
def test_cluster_costs_are_measured(cuda):
    for P in (2, 4, 8):
        bar, dsmem, smem = sw.cluster_costs(cuda, P, iters=1000)
        assert 0 < smem < dsmem and 0 < bar < 1e5


def _kernels_match_plain(cuda, case):
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
    with pytest.raises(ValueError, match="layout"):
        sw.sw_scan(p, t, pl, tl, d0, layout=(1, 1), **{**kw, "W": 2048})
    with pytest.raises(ValueError, match="on"):
        sw.sw_scan(p, t.cpu(), pl, tl, d0, **kw)
    best, bi, bk, ptrs = sw.sw_scan(p, t, pl, tl, d0, **kw)
    with pytest.raises(ValueError, match="pointer bytes"):
        sw.sw_traceback(ptrs, p, t, best, bi, bk, d0, W=64, L_OPS=8)
    B = ptrs.shape[1]
    shifted = ptrs.view(-1)[2:2 + 3 * B * 128].view(3, B, 128)
    with pytest.raises(ValueError, match="4-byte boundary"):
        sw.sw_traceback(shifted, p, t, best, bi, bk, d0, W=128, L_OPS=8)
