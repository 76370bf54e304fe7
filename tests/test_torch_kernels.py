"""Kernel wrappers of the port (kit4b_tpu_torch/kernels/: minmm, sweep,
take), their build, and device resolution.

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
from kit4b_tpu_torch.kernels.sweep import BIG, sweep, sweep_plain
from kit4b_tpu_torch.kernels.take import FILL, take, take_plain
from kit4b_tpu_torch.kmer.hammings import hammings_oracle
from kit4b_tpu_torch.kmer.hammings_mxu import build_w, hammings_exhaustive_mxu

S = 128
GP = 1024
# (K, diag, span_lo, span_cnt, row_base, R): diag on and off, span_lo > 0,
# non-zero row_base, own rows inside and outside the partner span, widths
# of one, two, two and six 128-byte blocks (K = 25, 40, 51, 153: Cw 128,
# 256, 256, 768), R = 384 (not a multiple of the kernel's 256 own rows)
# and a span of one 128-column tile
CASES = [
    (25, True, 0, 4, 0, 512),
    (25, True, 2, 3, 256, 384),
    (25, False, 1, 4, 128, 256),
    (40, True, 1, 6, 128, 896),
    (40, False, 0, 8, 0, 1024),
    (51, True, 2, 1, 256, 384),
    (51, False, 0, 3, 128, 384),
    (153, True, 1, 1, 128, 384),
    (153, False, 3, 2, 0, 384),
    (153, True, 0, 8, 512, 512),
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


def _check_build_paths(name):
    src, lib, log = build.paths(name)
    assert src == build.CSRC / f"{name}.cu" and src.is_file()
    assert lib.parent == log.parent == build.PKG / "_build"
    key = lib.stem.split("-")[-1]
    assert len(key) == 16 and int(key, 16) >= 0
    assert build.paths(name) == (src, lib, log)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_paths_are_keyed_by_the_source():
    _check_build_paths("minmm")


@pytest.mark.parametrize("name", ["sweep", "take"])
def test_build_paths_of_the_sweep_and_take_kernels(name):
    _check_build_paths(name)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # a kernel that is not built yet needs nvcc; without it the build raises
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setattr(build, "BUILD", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("sweep", "take")
    assert not list(tmp_path.iterdir())


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


# --- offset sweep (kernels/sweep.py) --------------------------------------

# (G, K, G_valid, partner: "self" or its length, d_lo, d_hi) at CPU sizes:
# the sense and antisense shapes of the engine, G_valid < G, a partner
# shorter than own, an offset slice and K = 1
SWEEP_CASES = [
    (300, 25, 300, "self", 1, None),
    (300, 7, 280, 300, 0, None),
    (400, 13, 400, 250, 0, 300),
    (350, 1, 350, "self", 1, None),
]
# the same at sizes of several 1,024-start tiles and 2,048-offset spans of
# the kernel, with offset slices that start and end inside a span and
# straddle a span boundary
SWEEP_CARD_CASES = [
    (5000, 25, 5000, "self", 1, None),
    (5000, 7, 4900, 5000, 0, None),
    (4500, 13, 4500, 3000, 100, 4000),
    (5000, 25, 5000, "self", 2040, 2056),
    (3000, 1, 3000, "self", 1, None),
]


def _sweep_inputs(G, partner, seed, device="cpu"):
    own = _genome(G, seed)
    if partner == "self":
        part = own
    else:   # another genome holding a copy of own[100:150]
        part = _genome(partner, seed + 1)
        part[partner // 2:partner // 2 + 50] = own[100:150]
    return (torch.from_numpy(own).to(device),
            torch.from_numpy(part).to(device))


def _direct_sweep(own, part, K, G_valid, d_lo, d_hi):
    """Direct numpy definition: every (i, d) pair scored on its own; codes
    at or past G_valid, or past the partner's end, read as EOG."""
    G = len(own)
    out = np.full(G, BIG, np.int64)
    n_win = G_valid - K + 1
    d_end = n_win if d_hi is None else min(d_hi, n_win)
    pad = np.full(G + K, 15, np.uint8)
    ow = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([own[:G_valid], pad]), K)
    pw = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([part[:G_valid], pad]), K)
    for d in range(d_lo, d_end):
        a, b = ow[:n_win - d], pw[d:n_win]
        ok = (a < 5).all(1) & (b < 5).all(1)
        ws = (a != b).sum(1)
        out[:n_win - d] = np.where(ok, np.minimum(out[:n_win - d], ws),
                                   out[:n_win - d])
    return out


@pytest.mark.parametrize("G,K,G_valid,partner,d_lo,d_hi", SWEEP_CASES)
def test_sweep_on_cpu_runs_plain_and_launches_nothing(G, K, G_valid, partner,
                                                      d_lo, d_hi):
    own, part = _sweep_inputs(G, partner, seed=G + K)
    kw = dict(K=K, G_valid=G_valid, d_lo=d_lo, d_hi=d_hi)
    before = sweep.launches
    got = sweep(own, part, **kw)
    assert sweep.launches == before
    assert got.dtype == torch.int32 and got.shape == (G,)
    assert torch.equal(got, sweep_plain(own, part, **kw))
    np.testing.assert_array_equal(
        got.numpy(), _direct_sweep(own.numpy(), part.numpy(), **kw))
    assert int(got.min()) <= 1   # the planted copies are found


def test_sweep_rejects_what_the_kernel_does_not_take():
    own, part = _sweep_inputs(300, "self", seed=1)
    with pytest.raises(ValueError, match="K must be in"):
        sweep(own, part, K=26, G_valid=300, d_lo=1)
    with pytest.raises(ValueError, match="uint8"):
        sweep(own.int(), part, K=25, G_valid=300, d_lo=1)
    with pytest.raises(ValueError, match="G_valid"):
        sweep(own, part, K=25, G_valid=301, d_lo=1)
    with pytest.raises(ValueError, match="one CUDA device"):
        sweep(own, part.to("meta"), K=25, G_valid=300, d_lo=1)


# --- gather (kernels/take.py) ---------------------------------------------

def _take_inputs(T, N, seed, device="cpu"):
    """An int32 table and indices: in range, counted from the end, and out
    of range on both sides."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-2**31, 2**31, T).astype(np.int32)
    idx = rng.integers(-T, T, N).astype(np.int32)
    idx[:8] = [-1, -T, -T - 1, T, T + 5, 0, T - 1, -(2**31)]
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(idx).to(device))


def _direct_take(table, idx):
    T = len(table)
    return np.array([table[i] if 0 <= i < T else
                     table[i + T] if -T <= i < 0 else FILL
                     for i in idx.tolist()], np.int32)


@pytest.mark.parametrize("T,N", [(1000, 3000), (7, 64), (1, 9)])
def test_take_on_cpu_runs_plain_and_launches_nothing(T, N):
    table, idx = _take_inputs(T, N, seed=T)
    before = take.launches
    got = take(table, idx)
    assert take.launches == before
    assert got.dtype == torch.int32 and got.shape == (N,)
    assert torch.equal(got, take_plain(table, idx))
    np.testing.assert_array_equal(got.numpy(),
                                  _direct_take(table.numpy(), idx.numpy()))


def test_take_of_an_empty_table_fills():
    idx = torch.tensor([0, -1, 5], dtype=torch.int32)
    got = take(torch.zeros(0, dtype=torch.int32), idx)
    assert got.tolist() == [FILL] * 3


def test_take_rejects_what_the_kernel_does_not_take():
    table, idx = _take_inputs(100, 10, seed=3)
    with pytest.raises(ValueError, match="int32"):
        take(table.long(), idx)
    with pytest.raises(ValueError, match="int32"):
        take(table, idx.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        take(table, idx.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("G,K,G_valid,partner,d_lo,d_hi",
                         SWEEP_CASES + SWEEP_CARD_CASES)
def test_sweep_kernel_matches_plain_on_card(cuda, G, K, G_valid, partner,
                                            d_lo, d_hi):
    own, part = _sweep_inputs(G, partner, seed=G + K, device=cuda)
    kw = dict(K=K, G_valid=G_valid, d_lo=d_lo, d_hi=d_hi)
    before = sweep.launches
    got = sweep(own, part, **kw)
    torch.cuda.synchronize()
    assert sweep.launches == before + 1
    assert torch.equal(got, sweep_plain(own, part, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N", [(1000, 3000), (7, 64), (262_144, 524_288)])
def test_take_kernel_matches_plain_on_card(cuda, T, N):
    table, idx = _take_inputs(T, N, seed=T, device=cuda)
    before = take.launches
    got = take(table, idx)
    torch.cuda.synchronize()
    assert take.launches == before + 1
    assert torch.equal(got, take_plain(table, idx))
