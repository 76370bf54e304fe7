"""Max-match kernel wrapper of the port (kit4b_tpu_torch/kernels/minmm.py),
its build, and device resolution.

CPU tests: for CPU tensors the wrapper runs the plain PyTorch version and
launches nothing. Tests marked `cuda` need an NVIDIA card and skip without
one; they hold the hand kernel to the plain version bit for bit. This file
imports no jax, so on a machine with a card it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import device as devmod
from kit4b_tpu_torch.kernels import build
from kit4b_tpu_torch.kernels.minmm import NEG, minmm, minmm_plain
from kit4b_tpu_torch.kmer.hammings import hammings_oracle
from kit4b_tpu_torch.kmer.hammings_mxu import build_w, hammings_exhaustive_mxu

S = 128
GP = 1024
# (K, diag, span_lo, span_cnt, row_base, R): diag on and off, span_lo > 0,
# non-zero row_base, own rows inside and outside the partner span, and a
# width of two 128-byte blocks (K = 40)
CASES = [
    (25, True, 0, 4, 0, 512),
    (25, True, 2, 3, 256, 384),
    (25, False, 1, 4, 128, 256),
    (40, True, 1, 6, 128, 896),
    (40, False, 0, 8, 0, 1024),
]


def _genome(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 3] = 7                      # EOS chrom separator
    g[rng.integers(0, n, 8)] = 4       # N bases
    g[n // 2 + 40:n // 2 + 80] = g[40:80]   # a repeat: distances 0
    return g


def _w(K, rc, device="cpu", G=900, seed=11):
    ext = np.concatenate([_genome(G, seed), np.full(GP + K - G, 15, np.uint8)])
    return build_w(torch.from_numpy(ext).to(device), K=K, Gp=GP, G=G, rc=rc)[0]


def _dense_maxm(wo, wp, diag, span_lo, span_cnt, row_base):
    """Direct numpy definition: one full [R, span] product."""
    c0, c1 = span_lo * S, (span_lo + span_cnt) * S
    m = wo.astype(np.int32) @ wp[c0:c1].astype(np.int32).T
    if diag:
        rows = row_base + np.arange(len(wo))[:, None]
        m = np.where(rows == np.arange(c0, c1)[None, :], NEG, m)
    return m.max(axis=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("K,diag,span_lo,span_cnt,row_base,R", CASES)
def test_wrapper_on_cpu_runs_plain_and_launches_nothing(
        K, diag, span_lo, span_cnt, row_base, R):
    W, Wrc = _w(K, False), _w(K, True)
    wp = W if diag else Wrc
    wo = W[row_base:row_base + R]
    before = minmm.launches
    got = minmm(wo, wp, diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
                row_base=row_base)
    assert minmm.launches == before
    plain = minmm_plain(wo, wp, diag=diag, span_lo=span_lo,
                        span_cnt=span_cnt, S=S, row_base=row_base)
    assert torch.equal(got, plain)
    want = _dense_maxm(wo.numpy(), wp.numpy(), diag, span_lo, span_cnt,
                       row_base)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_a_tensor_off_the_cpu_and_off_cuda():
    W = _w(25, False)
    with pytest.raises(ValueError, match="one CUDA device"):
        minmm(W[:128], W.to("meta"), diag=True, span_lo=0, span_cnt=1, S=S)


def test_resolve_device(monkeypatch):
    assert devmod.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        devmod.resolve("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in ("cuda", None, torch.device("cuda", 0)):
        with pytest.raises(devmod.DeviceUnavailable, match="--device cpu"):
            devmod.resolve(asked)


def test_build_paths_are_keyed_by_the_source():
    src, lib, log = build.paths("minmm")
    assert src == build.CSRC / "minmm.cu" and src.is_file()
    assert lib.parent == log.parent == build.PKG / "_build"
    key = lib.stem.split("-")[-1]
    assert len(key) == 16 and int(key, 16) >= 0
    assert build.paths("minmm") == (src, lib, log)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("K,diag,span_lo,span_cnt,row_base,R", CASES)
def test_kernel_matches_plain_on_card(cuda, K, diag, span_lo, span_cnt,
                                      row_base, R):
    W, Wrc = _w(K, False, cuda), _w(K, True, cuda)
    wp = W if diag else Wrc
    wo = W[row_base:row_base + R]
    before = minmm.launches
    got = minmm(wo, wp, diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
                row_base=row_base)
    torch.cuda.synchronize()
    assert minmm.launches == before + 1
    plain = minmm_plain(wo, wp, diag=diag, span_lo=span_lo,
                        span_cnt=span_cnt, S=S, row_base=row_base)
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("K,anti", [(7, True), (25, False), (25, True)])
def test_engine_on_card_matches_cpu_and_oracle(cuda, K, anti):
    g = _genome(300, seed=5)
    kw = dict(antisense=anti, T=256, S=128)
    got = hammings_exhaustive_mxu(g, K, device=cuda, **kw)
    np.testing.assert_array_equal(
        got, hammings_exhaustive_mxu(g, K, device="cpu", **kw))
    np.testing.assert_array_equal(got, hammings_oracle(g, K, antisense=anti))
