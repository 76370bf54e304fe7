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
from kit4b_tpu_torch.kernels import minmm as minmm_mod
from kit4b_tpu_torch.kernels.minmm import NEG, minmm, minmm_plain
from kit4b_tpu_torch.kernels.sweep import BIG, sweep, sweep_plain
from kit4b_tpu_torch.kernels.take import FILL, take, take_plain
from kit4b_tpu_torch.kmer import hammings_mxu
from kit4b_tpu_torch.kmer.hammings import hammings_oracle
from kit4b_tpu_torch.kmer.hammings_mxu import build_w, hammings_exhaustive_mxu
from test_torch_sweep_words import SPARSE, sparse_inputs

S = 128
GP = 1024
# (K, diag, span_lo, span_cnt, row_base, R): diag on and off, span_lo > 0,
# non-zero row_base, own rows inside and outside the partner span, widths
# of one, two, two and six 128-byte blocks (K = 25, 40, 51, 153: Cw 128,
# 256, 256, 768), R = 384 (not a multiple of the kernel's 512 own rows)
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
    before = minmm.launches, minmm.rows
    got = minmm(wo, wp, diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
                row_base=row_base)
    assert (minmm.launches, minmm.rows) == before
    plain = minmm_plain(wo, wp, diag=diag, span_lo=span_lo,
                        span_cnt=span_cnt, S=S, row_base=row_base)
    assert torch.equal(got, plain)
    want = _dense_maxm(wo.numpy(), wp.numpy(), diag, span_lo, span_cnt,
                       row_base)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K,diag,span_lo,span_cnt,row_base,R", CASES)
def test_wrapper_on_cpu_in_row_blocks_matches_dense(
        monkeypatch, K, diag, span_lo, span_cnt, row_base, R):
    # blocks of 128 own rows: the self pair's row_base moves with each
    monkeypatch.setattr(minmm_mod, "PLAIN_ROWS", 128)
    W, Wrc = _w(K, False), _w(K, True)
    wp = W if diag else Wrc
    wo = W[row_base:row_base + R]
    got = minmm(wo, wp, diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
                row_base=row_base)
    assert got.dtype == torch.int32 and got.shape == (R,)
    np.testing.assert_array_equal(got.numpy(), _dense_maxm(
        wo.numpy(), wp.numpy(), diag, span_lo, span_cnt, row_base))


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


@pytest.mark.parametrize("name", ["sweep", "take", "sp_probe"])
def test_build_paths_of_the_sweep_and_take_kernels(name):
    _check_build_paths(name)


def test_build_key_covers_the_headers(monkeypatch, tmp_path):
    # minmm.cu and sp_probe.cu include wgmma_sp.cuh: a changed header
    # builds them anew
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.paths("k")[1]
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.paths("k")[1] != before
    assert (build.CSRC / "k.cu").exists()


@pytest.mark.parametrize("rows,cols,K", [(12_072_960, 3_017_728, 25),
                                         (1 << 24, 753_664, 25),
                                         (131_072, 262_144, 153)])
def test_time_minmm_bounds_are_the_benchmarks(rows, cols, K):
    # the tool's and the smoke test's 2:4-sparse bound is kbench's
    # minmm_roofline bound; the dense one counts every stored channel
    from kbench.roofline import minmm_bound_s
    from kit4b_tpu_torch.tools.time_minmm import bounds_ms
    sparse, dense = bounds_ms(rows, cols, K)
    assert sparse == pytest.approx(
        minmm_bound_s(rows, cols, K, "NVIDIA H100 80GB HBM3") * 1e3,
        rel=1e-12)
    cw = 128 * -(-5 * K // 128)
    assert dense == pytest.approx(2 * rows * cols * cw / 1979e9, rel=1e-12)
    assert dense / sparse == pytest.approx(cw / (64 * -(-5 * K // 64)) * 2)


def test_fault_count_raises_and_resets():
    # the count the kernel keeps of own-row groups that are not 2:4
    dev = torch.device("cpu")
    minmm_mod.raise_on_faults(0, dev)
    minmm_mod.faults(dev).fill_(3)
    assert minmm_mod.faults(dev) is minmm_mod.faults("cpu")
    with pytest.raises(ValueError, match=r"hold 3 group\(s\) of 4 channels"):
        minmm_mod.check_faults(dev)
    assert int(minmm_mod.faults(dev)[0]) == 0
    minmm_mod.check_faults(dev)


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
    before = minmm.launches, minmm.rows
    got = minmm(wo, wp, diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
                row_base=row_base)
    torch.cuda.synchronize()
    assert (minmm.launches, minmm.rows) == (before[0] + 1, before[1] + R)
    plain = minmm_plain(wo, wp, diag=diag, span_lo=span_lo,
                        span_cnt=span_cnt, S=S, row_base=row_base)
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, (1 << 31) + 3 * S])
@pytest.mark.parametrize("K", [25, 51, 76, 102, 128, 153])
def test_sparse_kernel_matches_plain_at_every_width_on_card(cuda, K, base):
    # one-hot rows at Cw 128, 256, ..., 768 (the widest K of each): 896
    # own rows (not a multiple of a block's 512 or 128) whose diagonal
    # crosses the tiles, against 7 spans of 128 columns (the last tile
    # half full), sense with the self pairs masked and antisense, at bases
    # below and past 2^31
    W, Wrc = _w(K, False, cuda), _w(K, True, cuda)
    assert W.shape[1] == 128 * -(-5 * K // 128)
    for wp, diag in ((W, True), (Wrc, False)):
        kw = dict(diag=diag, span_lo=base // S + 1, span_cnt=7, S=S,
                  row_base=base + 128, col_base=base)
        got = minmm(W[128:], wp, **kw)
        torch.cuda.synchronize()
        minmm_mod.check_faults(cuda)
        assert torch.equal(got, minmm_plain(W[128:], wp, **kw))
        assert got.max() > 0


@pytest.mark.cuda
def test_own_rows_that_break_2_of_4_raise_on_card(cuda, monkeypatch):
    W = _w(25, False, cuda)
    wo = W[:256].clone()
    wo[5, :3] = 1                      # 3 non-zeros in one group
    wo[200, 4:8] = -1                  # and 4 in another
    minmm_mod.check_faults(cuda)
    minmm(wo, W, diag=True, span_lo=0, span_cnt=2, S=S)
    with pytest.raises(ValueError, match=r"hold 2 group\(s\) of 4 channels"):
        minmm_mod.check_faults(cuda)
    minmm_mod.check_faults(cuda)       # the count is back at 0
    # the node's path raises in place of returning the block
    g = _genome(5000, seed=8)
    eng = hammings_mxu.HammingsNode(g, 25, node=3, numnodes=10, T=256,
                                    S=128, device=cuda)
    real = hammings_mxu.onehot_windows

    def broken(*args, **kw):
        W, valid = real(*args, **kw)
        W[7, 8:12] = 1
        return W, valid
    monkeypatch.setattr(hammings_mxu, "onehot_windows", broken)
    # counted by each strand's launch
    with pytest.raises(ValueError, match=r"hold 2 group\(s\) of 4 channels"):
        eng.rows(0, 1000)
    monkeypatch.setattr(hammings_mxu, "onehot_windows", real)
    assert (eng.rows(0, 1000) < 25).sum() > 500


@pytest.mark.cuda
@pytest.mark.parametrize("K,anti", [(7, True), (25, False), (25, True)])
def test_engine_on_card_matches_cpu_and_oracle(cuda, K, anti):
    g = _genome(300, seed=5)
    kw = dict(antisense=anti, T=256, S=128)
    got = hammings_exhaustive_mxu(g, K, device=cuda, **kw)
    np.testing.assert_array_equal(
        got, hammings_exhaustive_mxu(g, K, device="cpu", **kw))
    np.testing.assert_array_equal(got, hammings_oracle(g, K, antisense=anti))


@pytest.mark.cuda
@pytest.mark.parametrize("anti", [True, False])
def test_node_run_on_card_launches_once_a_strand(cuda, monkeypatch, anti):
    # Gp = 2,398,208 own rows, past 2^21, so chunks of 2^21 make two a
    # strand; node 1 of 292 takes partner spans [8, 16)
    g = _genome((1 << 21) + 300_001, seed=3)
    Gp, strands = 2_398_208, 1 + anti
    kw = dict(antisense=anti, node=1, numnodes=292, device=cuda)
    runs = []
    for block, launches in ((None, strands), (1 << 21, 2 * strands)):
        with monkeypatch.context() as m:
            if block is not None:
                m.setattr(hammings_mxu, "BLOCK_ROWS", block)
            before = minmm.launches, minmm.rows
            runs.append(hammings_exhaustive_mxu(g, 25, **kw))
        assert (minmm.launches - before[0], minmm.rows - before[1]) == \
            (launches, Gp * strands)
    monkeypatch.setattr(hammings_mxu, "minmm", minmm_plain)
    plain = hammings_exhaustive_mxu(g, 25, **kw)
    assert (plain < 0xFFFF).sum() > len(g) // 2
    for got in runs:
        np.testing.assert_array_equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("anti", [True, False])
def test_node_rows_on_card_equal_cpu_and_are_the_callers_own(cuda,
                                                            monkeypatch,
                                                            anti):
    # node 3 of 10 of Gp = 5,120 takes columns [1536, 2048); the block
    # [1400, 5077) crosses them, the separator, and the rows from
    # G - K + 1 = 4,976 and past G, which read 0xFFFF
    g = _genome(5000, seed=8)
    kw = dict(antisense=anti, node=3, numnodes=10, T=256, S=128)
    monkeypatch.setattr(hammings_mxu.HammingsNode, "bytes_collected", 0)
    eng = hammings_mxu.HammingsNode(g, 25, device=cuda, **kw)
    got = eng.rows(1400, 5077)
    assert hammings_mxu.HammingsNode.bytes_collected == 2 * 3677
    want = hammings_mxu.HammingsNode(g, 25, device="cpu", **kw).rows(1400,
                                                                     5077)
    assert got.dtype == np.uint16 and got.shape == (3677,)
    np.testing.assert_array_equal(got, want)
    assert (got[4976 - 1400:] == 0xFFFF).all() and got[1666 - 1400] == 0xFFFF
    assert (got < 25).sum() > 3000
    kept = got.copy()
    eng.rows(0, 1000)
    np.testing.assert_array_equal(got, kept)
    assert eng.pinned.is_pinned() and eng.pinned.dtype == torch.uint16
    assert not np.shares_memory(got, eng.pinned.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("diag", [True, False])
def test_kernel_at_bases_past_2_31_matches_plain_on_card(cuda, diag):
    # own rows [B + 256, B + 4352) against a partner map of 2,048 columns
    # based at B + 1,024 (16 spans of 128, the last 10 selected): the self
    # pairs lie inside, where row and column pass 2^31 + 2^11
    B = (1 << 31) + 3 * S
    ext = np.concatenate([_genome(5000, 4), np.full(145, 15, np.uint8)])
    W = build_w(torch.from_numpy(ext).to(cuda), K=25, Gp=5120, G=5000,
                rc=not diag)[0]
    wo, wp = W[256:4352], W[1024:3072]
    kw = dict(diag=diag, span_lo=(B + 1024) // S + 6, span_cnt=10, S=S)
    got = minmm(wo, wp, row_base=B + 256, col_base=B + 1024, **kw)
    torch.cuda.synchronize()
    plain = minmm_plain(wo, wp, row_base=B + 256, col_base=B + 1024, **kw)
    assert torch.equal(got, plain)
    # the same pairs at bases below 2^31
    low = dict(kw, span_lo=1024 // S + 6)
    assert torch.equal(got, minmm(wo, wp, row_base=256, col_base=1024, **low))
    if diag:   # own rows whose self column is selected read their masks
        assert (got[1792 - 256:3072 - 256] < 25).all()


@pytest.mark.cuda
def test_node_rows_at_k100_past_2_31_bytes_equal_the_reference(cuda):
    # the first own operand past 2^31 bytes: a K 100 block (Cw 512) of
    # 2^22 + 200 own rows, padded to 2^22 + 256 (2^31 + 131,072 bytes of
    # one-hot), from row 2^31 + 2^20 of a genome of 2^31 + 2^23 bases;
    # node 32,800 of 32,896 takes the 65,536 columns from 2^31 + 2^21,
    # inside the block, so it holds self pairs. Planted in the block: a
    # sense and a reverse-complement copy of span windows (3 substitutions
    # each), an N run and a separator. Sampled rows, the last two tiles'
    # among them, equal kbench's plain reference; the kernel counts no
    # group that is not 2:4.
    from kbench.reference import hammings_rows as ref
    K, G, cols = 100, (1 << 31) + (1 << 23), 1 << 16
    r0, r1 = (1 << 31) + (1 << 20), (1 << 31) + (1 << 20) + (1 << 22) + 200
    numnodes, node = G // cols, ((1 << 31) + (1 << 21)) // cols
    c0 = node * cols
    gen = torch.Generator(device=cuda).manual_seed(5)
    seq = torch.randint(0, 4, (G,), dtype=torch.uint8, device=cuda,
                        generator=gen).cpu().numpy()
    rng = np.random.default_rng(7)
    sense = seq[c0 + 1000:c0 + 1300].copy()
    anti = (3 - seq[G - c0 - 3300:G - c0 - 3000][::-1]).astype(np.uint8)
    for d, seg in ((r0 + 5000, sense), (r0 + 9000, anti)):
        pick = rng.choice(300, 3, replace=False)
        seg[pick] = (seg[pick] + 1) % 4
        seq[d:d + 300] = seg
    seq[r0 + 20000:r0 + 20040] = 4          # an N run
    seq[r0 + 30000] = 7                     # a separator
    before = minmm.rows_by_cw.get(512, 0)
    eng = hammings_mxu.HammingsNode(seq, K, node=node, numnodes=numnodes,
                                    device=cuda)
    assert (eng.Gp, eng.c0, eng.c1) == (G, c0, c0 + cols)
    got = eng.rows(r0, r1)
    assert minmm.rows_by_cw[512] - before == 2 * ((1 << 22) + 256)
    assert int(minmm_mod.faults(cuda)[0]) == 0
    pos = np.concatenate([
        rng.integers(r0, r1, 1500), rng.integers(c0, c0 + cols, 300),
        np.arange(r0 + 5000, r0 + 5201, 10), np.arange(r0 + 9000,
                                                       r0 + 9201, 10),
        np.arange(r0 + 19890, r0 + 20060, 5), np.arange(r0 + 29900,
                                                        r0 + 30010, 5),
        np.arange(r1 - 200, r1)])
    want = ref.node_rows_min(seq, K, pos, node, numnodes, True, cuda)
    np.testing.assert_array_equal(got[pos - r0], want)
    assert (got[5000:5201] <= 3).all() and (got[9000:9201] <= 3).all()
    # N matches N: windows over the N run count, over the separator not
    assert (got[19941:20040] < 0xFFFF).all() and got[30000] == 0xFFFF
    assert (got < 70).sum() > len(got) - 1000


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
    (5000, 5, 5000, "self", 1, None),
    (5000, 24, 4990, 5000, 0, None),
    (9000, 24, 9000, "self", 4090, 6200),
    (4100, 1, 4100, 3000, 0, 2049),
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
@pytest.mark.parametrize("label", [c[0] for c in SPARSE])
def test_sweep_kernel_matches_plain_on_sparse_validity_on_card(cuda, label):
    # few valid windows in a tile, at bit positions that do not line up:
    # what the kernel's skip of 32 offsets must not drop
    own, part, K, d_lo, _ = sparse_inputs(label)
    own, part = torch.from_numpy(own).to(cuda), torch.from_numpy(part).to(cuda)
    kw = dict(K=K, G_valid=len(own), d_lo=d_lo)
    got, want = sweep(own, part, **kw), sweep_plain(own, part, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want < BIG).any()) and bool((want == BIG).any())


@pytest.mark.cuda
@pytest.mark.parametrize("T,N", [(1000, 3000), (7, 64), (262_144, 524_288),
                                 (1, 9), (262_144, 524_291), (1000, 3)])
def test_take_kernel_matches_plain_on_card(cuda, T, N):
    table, idx = _take_inputs(T, max(N, 8), seed=T, device=cuda)
    idx = idx[:N].clone()
    before = take.launches
    got = take(table, idx)
    torch.cuda.synchronize()
    assert take.launches == before + 1
    assert torch.equal(got, take_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N,skip", [(262_144, 524_288, 1), (1000, 3000, 2),
                                      (7, 64, 3), (1000, 9, 1)])
def test_take_kernel_takes_an_unaligned_view_on_card(cuda, T, N, skip):
    # idx[skip:] starts 4 * skip bytes past a 16-byte boundary: the kernel
    # gathers such a view one index at a time
    table, idx = _take_inputs(T, N, seed=T + skip, device=cuda)
    view = idx[skip:]
    assert view.data_ptr() % 16 == 4 * skip and view.is_contiguous()
    before = take.launches
    got = take(table, view)
    torch.cuda.synchronize()
    assert take.launches == before + 1
    assert torch.equal(got, take_plain(table, view))
