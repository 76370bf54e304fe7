"""The port's max-match hammings engine (kit4b_tpu_torch/kmer/hammings_mxu.py)
against the JAX package's (kit4b_tpu/kmer/hammings_mxu.py) and the numpy
oracle, on the CPU.

Both packages get the same numpy inputs. The JAX side runs its Pallas
kernel in interpret mode, as tests/test_hammings_mxu.py does. Every value is
an integer, so every comparison is exact (tolerance 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu.kmer import hammings as jh
from kit4b_tpu.kmer import hammings_kernel as jk
from kit4b_tpu.kmer import hammings_mxu as jm
from kit4b_tpu_torch import state
from kit4b_tpu_torch.kernels.minmm import minmm, minmm_plain
from kit4b_tpu_torch.kmer import hammings as th
from kit4b_tpu_torch.kmer import hammings_mxu as tm


def _genome(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 3] = 7                     # EOS chrom separator
    g[rng.integers(0, n, 6)] = 4      # N bases (valid, N == N matches)
    g[n - 60:n - 30] = g[20:50]       # a repeat: distance 0
    return g


def _ext(g, K, Gp):
    return np.concatenate([g, np.full(Gp + K - len(g), 0x0F, np.uint8)])


@pytest.mark.parametrize("rc", [False, True])
@pytest.mark.parametrize("K", [7, 13, 25])
def test_build_w_matches_jax(K, rc):
    g = _genome(333, seed=K)          # G not a multiple of the tile
    G, Gp = len(g), 512
    ext = _ext(g, K, Gp)
    Wj, vj = jm._build_w(jnp.asarray(ext), K=K, Gp=Gp, G=G, rc=rc)
    Wt, vt = tm.build_w(torch.from_numpy(ext), K=K, Gp=Gp, G=G, rc=rc)
    assert Wt.dtype == torch.int8 and Wt.shape == (Gp, 128 * -(-5 * K // 128))
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _nonzeros_per_group(W):
    """[rows, Cw / 4] non-zeros in each aligned group of 4 channels."""
    return (W.reshape(W.shape[0], -1, 4) != 0).sum(-1)


def _premise_genome(n, seed):
    """Codes with N runs, single Ns, separators and all four bases."""
    g = _genome(n, seed)
    g[40:52] = 4                      # an N run
    g[n // 2] = 7                     # a second separator
    g[n // 2 + 1:n // 2 + 30] = np.tile(np.arange(5, dtype=np.uint8), 6)[:29]
    return g


@pytest.mark.parametrize("rc", [False, True])
def test_onehot_rows_are_2_of_4_sparse_at_every_k(rc):
    # the premise of the card's 2:4-sparse kernel: every aligned group of 4
    # channels of an own row holds at most 2 non-zeros, for K 1-153 (Cw
    # 128-768), N runs, separators, the padded rows past G - K + 1 and the
    # reverse strand; build_w's rows and a block's rows from
    # onehot_windows alike
    g = _premise_genome(700, seed=9)
    G, Gp = len(g), 768
    worst = 0
    for K in range(1, 154):
        ext = torch.from_numpy(_ext(g, K, Gp))
        W, valid = tm.build_w(ext, K=K, Gp=Gp, G=G, rc=rc)
        assert W.shape[1] % 64 == 0 and (W[~valid] == 0).all()
        codes = tm.rc_codes(ext, G, 100, Gp + K) if rc else ext[100:]
        Wb, _ = tm.onehot_windows(codes, 100, Gp - 100, K=K, G=G)
        for w in (W, Wb):
            worst = max(worst, int(_nonzeros_per_group(w).max()))
        # a group holding 2 non-zeros exists wherever a window holds 2 bases
        assert int(_nonzeros_per_group(W).max()) == (2 if K > 1 else 1)
    assert worst == 2


# (diag, span_lo, span_cnt, row_base, R) with T = 256, S = 128, Gp = 1024
MINMM_CASES = [
    (True, 0, 4, 0, 512),
    (True, 2, 4, 256, 512),
    (False, 1, 3, 0, 256),
    (False, 3, 5, 512, 512),
]


@pytest.mark.parametrize("diag,span_lo,span_cnt,row_base,R", MINMM_CASES)
def test_minmm_plain_matches_pallas_interpret(diag, span_lo, span_cnt,
                                              row_base, R):
    K, T, S, Gp = 25, 256, 128, 1024
    g = _genome(1000, seed=7)
    ext = jnp.asarray(_ext(g, K, Gp))
    Wj, vj = jm._build_w(ext, K=K, Gp=Gp, G=len(g), rc=False)
    Wrcj, _ = jm._build_w(ext, K=K, Gp=Gp, G=len(g), rc=True)
    Wpj = Wj if diag else Wrcj
    want = jnp.max(jm._minmm_pallas(
        Wj[row_base:row_base + R], Wpj, K, diag=diag, span_lo=span_lo,
        span_cnt=span_cnt, T=T, S=S,
        row_base=jnp.asarray([row_base], jnp.int32), interpret=True), axis=1)
    _, W, _ = state.from_jax(g, np.asarray(Wj), np.asarray(vj), "cpu")
    _, Wp, _ = state.from_jax(g, np.asarray(Wpj), np.asarray(vj), "cpu")
    kw = dict(diag=diag, span_lo=span_lo, span_cnt=span_cnt, S=S,
              row_base=row_base)
    got = minmm_plain(W[row_base:row_base + R], Wp, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        minmm(W[row_base:row_base + R], Wp, **kw).numpy(), np.asarray(want))


def test_from_jax_checks_its_inputs():
    g = _genome(300, seed=1)
    W = np.zeros((512, 128), np.int8)
    v = np.zeros(512, bool)
    codes, Wt, vt = state.from_jax(g, W, v, "cpu")
    assert (codes.dtype, Wt.dtype, vt.dtype) == (torch.uint8, torch.int8,
                                                 torch.bool)
    with pytest.raises(ValueError, match="W"):
        state.from_jax(g, W[:, :100], v, "cpu")
    with pytest.raises(ValueError, match="valid"):
        state.from_jax(g, W, v[:10], "cpu")
    with pytest.raises(ValueError, match="codes"):
        state.from_jax(g.astype(np.int32), W, v, "cpu")


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("K", [7, 25])
def test_exhaustive_matches_jax_pallas_and_oracle(K, anti):
    g = _genome(300, seed=K + anti)
    kw = dict(antisense=anti, T=256, S=128)
    got = tm.hammings_exhaustive_mxu(g, K, device="cpu", **kw)
    want = jm.hammings_exhaustive_mxu(g, K, use_pallas=True, interpret=True,
                                      **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jh.hammings_oracle(g, K,
                                                          antisense=anti))


def test_exhaustive_defaults_match_jax_pallas():
    g = _genome(700, seed=5)
    got = tm.hammings_exhaustive_mxu(g, 25, device="cpu")
    want = jm.hammings_exhaustive_mxu(g, 25, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, want)


def test_node_partials_and_merge_match_jax():
    g = _genome(1100, seed=7)
    kw = dict(T=256, S=128)
    parts = []
    for node in range(3):
        got = tm.hammings_exhaustive_mxu(g, 13, node=node, numnodes=3,
                                         device="cpu", **kw)
        want = jm.hammings_exhaustive_mxu(g, 13, node=node, numnodes=3,
                                          use_pallas=True, interpret=True,
                                          **kw)
        np.testing.assert_array_equal(got, want)
        parts.append(got)
    full = tm.hammings_exhaustive_mxu(g, 13, device="cpu", **kw)
    np.testing.assert_array_equal(th.merge(*parts), full)
    np.testing.assert_array_equal(full, jm.hammings_exhaustive_mxu(
        g, 13, use_pallas=True, interpret=True, **kw))


def test_row_chunk_short_tail_matches_jax(monkeypatch):
    # Gp = 1280 is not a multiple of the 512-row block: the port's last
    # block runs its own 256 rows, JAX's row_chunk 400 overlaps the one
    # before; the maxima agree
    g = _genome(1200, seed=9)
    kw = dict(T=256, S=128)
    whole = tm.hammings_exhaustive_mxu(g, 25, device="cpu", **kw)
    monkeypatch.setattr(tm, "BLOCK_ROWS", 512)
    got = tm.hammings_exhaustive_mxu(g, 25, device="cpu", **kw)
    want = jm.hammings_exhaustive_mxu(g, 25, use_pallas=True, interpret=True,
                                      row_chunk=400, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, whole)


def _record_minmm(monkeypatch, module, partners=False):
    """Each call of `module.minmm` as (row_base, own rows, diag), with
    `partners` also (col_base, partner rows, span_lo, span_cnt), in order;
    the calls still run."""
    calls, real = [], module.minmm

    def recorded(W_own, W_part, **kw):
        calls.append((kw["row_base"], W_own.shape[0], kw["diag"]) + (
            (kw.get("col_base", 0), W_part.shape[0], kw["span_lo"],
             kw["span_cnt"]) if partners else ()))
        return real(W_own, W_part, **kw)
    monkeypatch.setattr(module, "minmm", recorded)
    return calls


@pytest.mark.parametrize("anti", [True, False])
def test_default_node_run_launches_once_a_strand(monkeypatch, anti):
    g = _genome(1100, seed=3)         # Gp = 1280 with T = 256
    kw = dict(antisense=anti, node=1, numnodes=3, T=256, S=128,
              device="cpu")
    calls = _record_minmm(monkeypatch, tm)
    got = tm.hammings_exhaustive_mxu(g, 13, **kw)
    assert calls == [(0, 1280, True)] + [(0, 1280, False)] * anti
    monkeypatch.setattr(tm, "BLOCK_ROWS", 256)
    np.testing.assert_array_equal(got, tm.hammings_exhaustive_mxu(g, 13,
                                                                  **kw))


@pytest.mark.parametrize("chunk", [1, 300, 400, 1000, 5000])
def test_row_chunks_cover_every_row_once(monkeypatch, chunk):
    # blocks of chunk rows rounded up to T
    g = _genome(1200, seed=9)         # Gp = 1280 with T = 256
    kw = dict(T=256, S=128, device="cpu")
    whole = tm.hammings_exhaustive_mxu(g, 25, **kw)
    R = -(-chunk // 256) * 256
    monkeypatch.setattr(tm, "BLOCK_ROWS", R)
    calls = _record_minmm(monkeypatch, tm)
    got = tm.hammings_exhaustive_mxu(g, 25, **kw)
    R = min(R, 1280)
    for diag in (True, False):
        spans = [(rb, n) for rb, n, d in calls if d == diag]
        assert spans == [(rb, min(R, 1280 - rb)) for rb in range(0, 1280, R)]
        runs = np.zeros(1280, int)
        for rb, n in spans:
            runs[rb:rb + n] += 1
        assert (runs == 1).all()
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_mesh_launches_once_a_shard_and_strand(monkeypatch, D):
    from kit4b_tpu_torch.parallel import hammings_mesh as pm
    g = _genome(1100, seed=4)
    calls = _record_minmm(monkeypatch, tm)
    got = pm.hammings_mesh(g, 13, devices=[torch.device("cpu")] * D,
                           T=256, S=128)
    Gp = -(-1100 // max(D * 256, 128)) * max(D * 256, 128)
    R = Gp // D
    assert calls == [(i * R, R, diag) for i in range(D)
                     for diag in (True, False)]
    np.testing.assert_array_equal(got, tm.hammings_exhaustive_mxu(
        g, 13, device="cpu", T=256, S=128))


def test_mesh_shards_run_against_the_node_span_alone(monkeypatch):
    """`-M` at D 4, node 1 of 3 (0-based): one node engine for the one
    device, built with T' = 4 * 256, whose Gp = 2,048 is the mesh's; a
    launch a shard and strand at row base i * 512 against the node's
    partner columns [640, 1280) alone (spans [5, 10) of 128)."""
    from kit4b_tpu_torch.parallel import hammings_mesh as pm
    g = _genome(1900, seed=6)
    monkeypatch.setattr(tm.HammingsNode, "partner_cols_built", 0)
    calls = _record_minmm(monkeypatch, tm, partners=True)
    got = pm.hammings_mesh(g, 13, devices=[torch.device("cpu")] * 4,
                           node=1, numnodes=3, T=256, S=128)
    assert calls == [(i * 512, 512, diag, 640, 640, 5, 5) for i in range(4)
                     for diag in (True, False)]
    assert tm.HammingsNode.partner_cols_built == 2 * 640
    np.testing.assert_array_equal(got, tm.hammings_exhaustive_mxu(
        g, 13, node=1, numnodes=3, T=4 * 256, S=128, device="cpu"))


@pytest.mark.parametrize("anti", [True, False])
def test_ring_runs_every_shard_against_each_partner_block(monkeypatch,
                                                          anti):
    """`-R` at D 4 on `[cpu] * 4`: B = 512 (Gp = 2,048); for each partner
    block j a node engine whose span is block j, built once, then the 4
    shards against it: D^2 launches a strand, and D partner blocks built,
    not D^2."""
    from kit4b_tpu_torch.parallel import hammings_ring as pr
    g = _genome(1900, seed=2)
    monkeypatch.setattr(tm.HammingsNode, "partner_cols_built", 0)
    calls = _record_minmm(monkeypatch, tm, partners=True)
    got = pr.hammings_ring(g, 13, antisense=anti,
                           devices=[torch.device("cpu")] * 4, T=256, S=128)
    strands = (True, False) if anti else (True,)
    assert calls == [(i * 512, 512, diag, j * 512, 512, 4 * j, 4)
                     for j in range(4) for i in range(4)
                     for diag in strands]
    assert tm.HammingsNode.partner_cols_built == 4 * 512 * len(strands)
    np.testing.assert_array_equal(got, tm.hammings_exhaustive_mxu(
        g, 13, antisense=anti, T=256, S=128, device="cpu"))


@pytest.mark.parametrize("engine,D", [("mesh", 2), ("mesh", 4),
                                      ("ring", 2)])
def test_shard_rows_in_blocks_run_each_own_row_once(monkeypatch, engine,
                                                    D):
    """With BLOCK_ROWS below a shard's R, a shard's own rows go in blocks;
    every own row of the padded genome is launched exactly once a strand
    and partner block, and the result does not change."""
    from kit4b_tpu_torch.parallel import hammings_mesh as pm
    from kit4b_tpu_torch.parallel import hammings_ring as pr
    g = _genome(1100, seed=5)
    run = pm.hammings_mesh if engine == "mesh" else pr.hammings_ring
    kw = dict(devices=[torch.device("cpu")] * D, T=256, S=128)
    whole = run(g, 13, **kw)
    Gp = -(-1100 // (D * 256)) * D * 256
    R = Gp // D
    monkeypatch.setattr(tm, "BLOCK_ROWS", 384)
    calls = _record_minmm(monkeypatch, tm, partners=True)
    got = run(g, 13, **kw)
    partners = sorted({c[3] for c in calls})
    assert len(partners) == (1 if engine == "mesh" else D)
    for col in partners:
        for diag in (True, False):
            spans = [(rb, n) for rb, n, d, cb, *_ in calls
                     if d == diag and cb == col]
            assert spans == [(rb, min(384, (i + 1) * R - rb))
                             for i in range(D)
                             for rb in range(i * R, (i + 1) * R, 384)]
            runs = np.zeros(Gp, int)
            for rb, n in spans:
                runs[rb:rb + n] += 1
            assert (runs == 1).all()
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("case", ["G<K", "all sentinels", "one window"])
def test_edge_cases_match_jax(case):
    if case == "G<K":
        g, K, anti = np.zeros(5, np.uint8), 9, True
    elif case == "all sentinels":
        g, K, anti = np.full(300, 7, np.uint8), 9, True
    else:   # sense only with a single valid window: no partner exists
        g, K, anti = np.full(300, 7, np.uint8), 9, False
        g[100:109] = [0, 1, 2, 3, 0, 1, 2, 3, 0]
    got = tm.hammings_exhaustive_mxu(g, K, antisense=anti, device="cpu",
                                     T=256, S=128)
    want = jm.hammings_exhaustive_mxu(g, K, antisense=anti, use_pallas=True,
                                      interpret=True, T=256, S=128)
    assert got.dtype == np.uint16 and got.shape == (len(g),)
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFFFF).all()
    # the dispatching entry point keeps the JAX package's G < K result
    np.testing.assert_array_equal(
        th.hammings_exhaustive(g, K, antisense=anti, device="cpu"),
        jh.hammings_exhaustive(g, K, antisense=anti))


def test_legacy_sweep_is_not_ported():
    # the legacy XLA sweep stays unported; its kernel path runs the port's
    # offset-sweep engine and gives the JAX package's result
    g = _genome(300, 1)
    with pytest.raises(NotImplementedError, match="_sweep_range"):
        th.hammings_exhaustive(g, 9, legacy_sweep=True, device="cpu")
    got = th.hammings_exhaustive(g, 9, legacy_sweep=True, use_kernel=True,
                                 device="cpu")
    np.testing.assert_array_equal(got, jk.hammings_exhaustive_tpu(
        g, 9, tile=512, span=512, interpret=True))
