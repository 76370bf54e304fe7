"""The streamed node engine of exhaustive hammings
(kit4b_tpu_torch/kmer/hammings_mxu.py `HammingsNode`): own rows in blocks
against the partner one-hot of the node's span alone, on the CPU (the
plain version of the max-match kernel), held to the benchmark's plain
reference (kbench/reference/hammings_rows.py), to the numpy oracle and
to the JAX package's engine (its kernel in interpret mode); the fold of a
block's maxima into distances, byte for byte; the kernel wrapper's 64-bit
row and column bases, on the plain version and through a stub of the
kernel's library."""
import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from kbench.reference import hammings_rows as ref
from kit4b_tpu.kmer import hammings_mxu as jm
from kit4b_tpu_torch import dna
from kit4b_tpu_torch.kernels import minmm as minmm_mod
from kit4b_tpu_torch.kmer import hammings_mxu as hm
from kit4b_tpu_torch.kmer.hammings import hammings_oracle

TS = dict(T=256, S=128)


def _genome(lengths, seed, copy_len):
    """Chromosomes of seeded bases, each followed by EOS (the last by
    EOG), with an N run in each and, from the first, a forward and a
    reverse-complement near-copy (two substitutions) in the last."""
    rng = np.random.default_rng(seed)
    chroms = [rng.integers(0, 4, n).astype(np.uint8) for n in lengths]
    for c in chroms:
        d = int(rng.integers(0, len(c) - 30))
        c[d:d + int(rng.integers(3, 30))] = dna.BASE_N
    src = chroms[0][100:100 + 2 * copy_len].copy()
    fwd, rc = src[:copy_len].copy(), src[copy_len:][::-1].copy()
    rc = np.where(rc < 4, 3 - rc, rc).astype(np.uint8)
    for seg in (fwd, rc):
        pick = rng.choice(copy_len, 2, replace=False)
        seg[pick] = (seg[pick] + 1) % 4
    chroms[-1][50:50 + copy_len] = fwd
    chroms[-1][-50 - copy_len:-50] = rc
    parts = []
    for c in chroms:
        parts += [c, np.array([dna.BASE_EOS], np.uint8)]
    g = np.concatenate(parts)
    g[-1] = dna.BASE_EOG
    return g


G_NODE = _genome([3000, 2500, 3400], 7, 200)     # G = 8,903, Gp = 8,960
G_SMALL = _genome([240, 260, 230], 8, 40)        # G = 733, Gp = 768


@pytest.mark.parametrize("K,node,numnodes,anti,chunk", [
    (25, 3, 8, True, 1000),       # blocks of 1,024, the last of 1,024
    (25, 5, 7, True, 3000),       # blocks of 3,072 (the last one shorter)
    (13, 0, 9, True, 2100),       # node 0: the copies' sources in its span
    (13, 1, 9, False, 2100),      # one strand
    (25, 6, 7, True, None),       # the default: all Gp rows at once
    (100, 0, 35, True, 1000),     # K 100 (Cw 512): node 0's two spans
    (100, 0, 35, False, 1000),    # hold the copies' sources; one strand
])
def test_node_in_row_blocks_equals_the_reference(monkeypatch, K, node,
                                                 numnodes, anti, chunk):
    if chunk is not None:     # blocks of chunk rows rounded up to T
        monkeypatch.setattr(hm, "BLOCK_ROWS", -(-chunk // 256) * 256)
    got = hm.hammings_exhaustive_mxu(G_NODE, K, antisense=anti, node=node,
                                     numnodes=numnodes, device="cpu", **TS)
    pos = np.arange(len(G_NODE))
    want = ref.node_rows_min(G_NODE, K, pos, node, numnodes, anti, "cpu",
                             **TS)
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFFFF).sum() < 0.1 * len(got)
    if node == 0:     # columns [0, 896) (of 35 nodes [0, 256)): each
        # copy's sense source and the reverse-complement copy's windows on
        # the antisense strand
        assert (got[5552:5752 - K + 1] <= 2).all()    # the forward copy
        if anti:      # the reverse-complement copy's source
            assert (got[300:500 - K + 1] <= 2).all()


def test_rows_of_any_range_equal_the_whole_sweep():
    """`rows` on ranges that start and end off the 128-row tile, across
    the node's span and at the padded genome's end."""
    kw = dict(antisense=True, node=4, numnodes=9, device="cpu", **TS)
    whole = hm.hammings_exhaustive_mxu(G_NODE, 25, **kw)
    eng = hm.HammingsNode(G_NODE, 25, **kw)
    assert (eng.c0, eng.c1, eng.Gp) == (3968, 4864, 8960)
    for r0, r1 in [(0, 1), (3900, 5077), (4863, 4865), (8800, 8960),
                   (7, 7)]:
        got = eng.rows(r0, r1)
        assert got.dtype == np.uint16 and len(got) == r1 - r0
        want = np.full(r1 - r0, 0xFFFF, np.uint16)
        want[:max(0, len(G_NODE) - r0)] = whole[r0:r1]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("anti", [True, False])
def test_merging_every_node_equals_the_oracle(monkeypatch, anti):
    monkeypatch.setattr(hm, "BLOCK_ROWS", 256)
    parts = [hm.hammings_exhaustive_mxu(G_SMALL, 13, antisense=anti, node=n,
                                        numnodes=4, device="cpu", **TS)
             for n in range(4)]
    np.testing.assert_array_equal(np.minimum.reduce(parts),
                                  hammings_oracle(G_SMALL, 13,
                                                  antisense=anti))


def test_each_own_row_is_built_once_a_pass(monkeypatch):
    monkeypatch.setattr(hm.HammingsNode, "own_rows_built", 0)
    monkeypatch.setattr(hm.HammingsNode, "partner_cols_built", 0)
    monkeypatch.setattr(hm, "BLOCK_ROWS", 1536)
    hm.hammings_exhaustive_mxu(G_NODE, 25, node=2, numnodes=8,
                               device="cpu", **TS)
    # Gp = 8,960 own rows in blocks of 1,536; the node's 9 spans of 128
    # columns on both strands
    assert hm.HammingsNode.own_rows_built == 8960
    assert hm.HammingsNode.partner_cols_built == 2 * 1152
    eng = hm.HammingsNode(G_NODE, 25, node=2, numnodes=8, device="cpu", **TS)
    eng.rows(100, 301)          # 201 rows: one tile of padding past them
    assert hm.HammingsNode.own_rows_built == 8960 + 256


@pytest.mark.parametrize("K,anti", [(13, True), (13, False), (25, True),
                                    (25, False), (100, True), (100, False)])
def test_block_equals_the_jax_engine(K, anti):
    """A block of node 2 of 6 from row 300 past G: a separator, N runs,
    the windows from G - K + 1 on and the rows past G read 0xFFFF; the
    block is padded past r1 = 750 to 512 rows, beyond Gp = 768. At K 100
    (Cw 512) the separators leave 233 of its rows valid."""
    kw = dict(antisense=anti, node=2, numnodes=6, **TS)
    want = jm.hammings_exhaustive_mxu(G_SMALL, K, use_pallas=True,
                                      interpret=True, **kw)
    eng = hm.HammingsNode(G_SMALL, K, device="cpu", **kw)
    got = eng.rows(300, 750)
    assert got.dtype == np.uint16 and len(got) == 450
    np.testing.assert_array_equal(got[:433], want[300:])
    assert (got[len(G_SMALL) - K + 1 - 300:] == 0xFFFF).all()
    assert got[201] == 0xFFFF        # the separator
    assert (got < K).sum() > (300 if K < 100 else 200)


def _lone_partner_genome(K):
    """G = 256 + K bases: with T 256 and S 128, node 2 of 4 takes columns
    [256, 384), where only window 256 is valid. Window 100 equals it;
    window 0 differs from it at every base."""
    g = np.random.default_rng(K).integers(0, 4, 256 + K).astype(np.uint8)
    g[100:100 + K] = g[256:]
    g[:K] = (g[256:] + 1) % 4
    return g


def test_fold_of_a_lone_partner_and_of_the_self_pair():
    """One strand: row 100 copies the span's one valid window (0), row 0
    differs from it at every base (K), and row 256, the window itself, has
    no partner but its masked self pair and the span's invalid windows,
    whose all-zero rows match nothing: K, as in the JAX package; every
    row from G - K + 1 on is 0xFFFF."""
    K = 13
    g = _lone_partner_genome(K)
    eng = hm.HammingsNode(g, K, antisense=False, node=2, numnodes=4,
                          device="cpu", **TS)
    assert (eng.c0, eng.c1, eng.Gp) == (256, 384, 512)
    got = eng.rows(0, 512)
    assert (got[0], got[100], got[256]) == (K, 0, K)
    assert (got[257:] == 0xFFFF).all() and (got[:256] <= K).all()
    np.testing.assert_array_equal(got[:len(g)], jm.hammings_exhaustive_mxu(
        g, K, antisense=False, node=2, numnodes=4, use_pallas=True,
        interpret=True, **TS))


def test_fold_caps_a_row_whose_every_partner_is_masked(monkeypatch):
    """A row whose maximum reads NEG on both strands folds to 0xFFFF, on
    one strand to the other's distance; invalid rows stay 0xFFFF."""
    def masked(W_own, W_part, **kw):
        mm = minmm_mod.minmm_plain(W_own, W_part, **kw)
        mm[:40 if kw["diag"] else 20] = minmm_mod.NEG
        return mm
    eng = hm.HammingsNode(G_NODE, 25, node=4, numnodes=9, device="cpu", **TS)
    want = eng.rows(8800, 8960)
    monkeypatch.setattr(hm, "minmm", masked)
    got = eng.rows(8800, 8960)
    assert (got[:20] == 0xFFFF).all() and (want[:20] < 25).all()
    assert ((want[20:40] <= got[20:40]) & (got[20:40] <= 25)).all()
    np.testing.assert_array_equal(got[40:], want[40:])
    assert (want[8903 - 25 + 1 - 8800:] == 0xFFFF).all()


def test_rows_returns_a_new_array_and_counts_2_bytes_a_row(monkeypatch):
    monkeypatch.setattr(hm.HammingsNode, "bytes_collected", 0)
    eng = hm.HammingsNode(G_NODE, 25, node=4, numnodes=9, device="cpu", **TS)
    first = eng.rows(3900, 5077)
    kept = first.copy()
    assert hm.HammingsNode.bytes_collected == 2 * 1177
    second = eng.rows(3901, 5078)
    assert hm.HammingsNode.bytes_collected == 2 * 1177 * 2
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(second[:-1], kept[1:])
    assert not np.shares_memory(first, second)
    eng.rows(7, 7)          # an empty range collects nothing
    assert hm.HammingsNode.bytes_collected == 2 * 1177 * 2


def _w(g, K, rc):
    Gp = -(-len(g) // 128) * 128
    ext = np.concatenate([g, np.full(Gp + K - len(g), dna.BASE_EOG,
                                     np.uint8)])
    return hm.build_w(torch.from_numpy(ext), K=K, Gp=Gp, G=len(g), rc=rc)[0]


@pytest.mark.parametrize("diag", [True, False])
def test_plain_at_bases_shifted_past_2_31_equals_unshifted(diag):
    shift = (1 << 31) + 3 * 128
    W = _w(G_NODE, 25, rc=not diag)
    wo, wp = W[1024:3072], W[1536:4096]       # the self pairs inside
    kw = dict(diag=diag, span_cnt=12, S=128)
    low = minmm_mod.minmm_plain(wo, wp, span_lo=14, row_base=1024,
                                col_base=1536, **kw)
    high = minmm_mod.minmm_plain(wo, wp, span_lo=14 + shift // 128,
                                 row_base=1024 + shift, col_base=1536 + shift,
                                 **kw)
    assert torch.equal(low, high)
    whole = minmm_mod.minmm_plain(wo, W, span_lo=14, row_base=1024, **kw)
    assert torch.equal(low, whole)


STUB = r"""
static long long seen[13];
int minmm_launch(int device, const void* w_own, const void* w_part,
                 long long rows, long long part_rows, int cw,
                 long long col_lo, long long col_hi, int diag,
                 long long row_base, long long col_base, void* out,
                 void* stream) {
  seen[0] = device; seen[3] = rows; seen[4] = part_rows; seen[5] = cw;
  seen[6] = col_lo; seen[7] = col_hi; seen[8] = diag; seen[9] = row_base;
  seen[10] = col_base;
  return 0;
}
long long minmm_seen(int i) { return seen[i]; }
"""


@pytest.fixture
def stub_lib(tmp_path):
    """A library with the kernel's C entry that records its arguments."""
    cxx = shutil.which("g++") or shutil.which("gcc")
    if cxx is None:
        pytest.skip("no C compiler to build the stub library")
    src, so = tmp_path / "stub.c", tmp_path / "libstub.so"
    src.write_text(STUB)
    subprocess.run([cxx, "-x", "c", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = minmm_mod.bind(ctypes.CDLL(str(so)))
    lib.minmm_seen.argtypes = [ctypes.c_int]
    lib.minmm_seen.restype = ctypes.c_longlong
    return lib


def _launch_through(monkeypatch, lib):
    """The wrapper's launch path into `lib` on meta tensors (no data, no
    card), with the device checks and CUDA's stream lookups stood in for,
    and its counters at 0."""
    monkeypatch.setattr(minmm_mod, "_lib", lambda: lib)
    monkeypatch.setattr(minmm_mod, "_on_one_card", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(minmm_mod.minmm, "launches", 0)
    monkeypatch.setattr(minmm_mod.minmm, "rows", 0)
    monkeypatch.setattr(minmm_mod.minmm, "rows_by_cw", {})


def test_wrapper_passes_64_bit_bases_unchanged(monkeypatch, stub_lib):
    """The wrapper's launch path on meta tensors."""
    _launch_through(monkeypatch, stub_lib)
    base = (1 << 31) + 3 * 128
    wo = torch.empty((4096, 128), dtype=torch.int8, device="meta")
    wp = torch.empty((2048, 128), dtype=torch.int8, device="meta")
    out = minmm_mod.minmm(wo, wp, diag=True, span_lo=base // 128 + 5,
                          span_cnt=7, S=128, row_base=base + 256,
                          col_base=base)
    assert out.shape == (4096,) and out.dtype == torch.int32
    seen = [stub_lib.minmm_seen(i) for i in range(11)]
    assert seen[3:11] == [4096, 2048, 128, 640, 1536, 1, base + 256, base]
    assert (minmm_mod.minmm.launches, minmm_mod.minmm.rows) == (1, 4096)
    assert minmm_mod.minmm.rows_by_cw == {128: 4096}
    with pytest.raises(ValueError, match="outside W_part"):
        minmm_mod.minmm(wo, wp, diag=True, span_lo=base // 128 - 1,
                        span_cnt=2, S=128, col_base=base)


def test_rows_by_cw_counts_a_block_under_its_stored_width(monkeypatch,
                                                          stub_lib):
    """`HammingsNode.rows` blocks whose launches go through the
    wrapper's launch path (meta copies of the operands into the stub) and
    whose result is the plain version's: 1,177 own rows padded to 1,280, a
    launch a strand, counted under Cw 128 at K 25 and 512 at K 100."""
    _launch_through(monkeypatch, stub_lib)

    def launched(W_own, W_part, **kw):
        minmm_mod.minmm(W_own.to("meta"), W_part.to("meta"), **kw)
        return minmm_mod.minmm_plain(W_own, W_part, **kw)
    monkeypatch.setattr(hm, "minmm", launched)
    kw = dict(node=4, numnodes=9, device="cpu", **TS)
    want = {}
    for K, cw in ((25, 128), (100, 512)):
        got = hm.HammingsNode(G_NODE, K, **kw).rows(3900, 5077)
        want[cw] = 2 * 1280
        assert minmm_mod.minmm.rows_by_cw == want
        assert (got < K).sum() > 1000
    assert minmm_mod.minmm.launches == 4


GRCH38 = [248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
          159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
          114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
          58617616, 64444167, 46709983, 50818468, 156040895, 57227415]


def test_hmg_fits_the_formats_32_bit_length(tmp_path, monkeypatch):
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
    from kit4b_tpu_torch.kmer import hammings
    assert not hammings.hmg_fits(GRCH38, 25)
    assert hammings.hmg_fits(GRCH38[:5], 25)
    # the header (4,014 bytes), then 89 bytes and 2 a distance a chromosome
    edge = (1 << 31) - 4014 - 89
    assert hammings.hmg_fits([edge // 2 + 24], 25) == (edge % 2 == 1)
    assert not hammings.hmg_fits([edge // 2 + 25], 25)
    # the CLI refuses before the sweep; .npy takes any genome
    fa = tmp_path / "g.fa"
    write_fasta(str(fa), [SeqRecord("c1", "", G_SMALL[:240])])
    monkeypatch.setattr(hammings, "hmg_fits", lambda lengths, K: False)
    with pytest.raises(SystemExit, match="at most 2 GiB"):
        cli.main(["hammings", "-i", str(fa), "-o", str(tmp_path / "o.hmg"),
                  "-K", "13", "--device", "cpu"])
    assert cli.main(["hammings", "-i", str(fa), "-o",
                     str(tmp_path / "o.npy"), "-K", "13",
                     "--device", "cpu"]) == 0
