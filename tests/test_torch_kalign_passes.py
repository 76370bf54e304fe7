"""The port's kalign device passes (kit4b_tpu_torch/ops, align/kalign.py)
against the JAX package on the same numpy inputs, exactly (every value is
an integer): the device tables, read planes and seed keys, the v4 and v5
tier-1 cores, the packed passes with E large and small enough to leave -3
rows, the full-stats escalation pass, and KAligner.align_batch_raw. Uses
the 120 kbp random and repeat-planted genomes of test_seed_extend_v5.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu import dna
from kit4b_tpu.align import kalign as jk
from kit4b_tpu.index.sfx_index import SfxIndex
from kit4b_tpu.io.fasta import Genome
from kit4b_tpu.ops import seed_extend_fast as jfast
from kit4b_tpu.ops import seed_extend_v4 as jv4
from kit4b_tpu.ops import seed_extend_v5 as jv5
from kit4b_tpu.sim import simreads
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.ops import seed_extend_fast as pfast
from kit4b_tpu_torch.ops import seed_extend_v4 as pv4
from kit4b_tpu_torch.ops import seed_extend_v5 as pv5

B = 512
_STATIC = ("genome_len", "offsets", "lut_k", "read_len", "n_compact",
           "n_extend", "max_per_bucket")
# jitted: eager op-by-op dispatch of the JAX cores costs more than a compile
jcore4 = jax.jit(jv4._cands_core_v4, static_argnames=_STATIC)
jcore5 = jax.jit(jv5._cands_core_v5, static_argnames=_STATIC[:-1])


@pytest.fixture(scope="module", params=["random", "repeats"])
def setup(request):
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    rng = np.random.default_rng(23)
    G = 120_000
    seq = rng.integers(0, 4, G).astype(np.uint8)
    if request.param == "repeats":
        # 30 copies of a 400bp unit: buckets with cnt >> P_POS, multiloci
        unit = rng.integers(0, 4, 400).astype(np.uint8)
        for i in range(30):
            p = 1000 + i * 3500
            seq[p:p + 400] = unit
    seq = np.concatenate([seq, [dna.BASE_EOG]]).astype(np.uint8)
    g = Genome(["c1"], np.array([0]), np.array([G]), seq)
    idx = SfxIndex.build(g)
    return request.param, g, idx


def _reads(g, L, n_rate, n=B):
    recs = simreads.sim_reads(
        g, simreads.SimParams(n_reads=n, read_len=L, seed=L,
                              error_mode="illumina", subs_rate=0.03))
    reads = np.stack([r.codes for r in recs])
    if n_rate:
        mask = np.random.default_rng(L + 1).random(reads.shape) < n_rate
        reads[mask] = dna.BASE_N
    return reads


class Case:
    """The JAX aligner's device arrays and the port's for one read length,
    plus the pass arguments both take."""

    def __init__(self, idx, L):
        self.L = L
        self.ja = jk.KAligner(idx, batch_size=B)
        self.pa = pk.KAligner(idx, batch_size=B, device="cpu")
        self.j = self.ja._device_for(L)
        self.j4 = jv5.make_lut4_device(idx.lut, self.j[1])
        gview, sa, lut, lut2 = self.pa._device_for(L)
        self.p = (gview, sa, lut, lut2)
        self.p4 = pv5.make_lut4_device(lut, sa)
        _, self.mtm = self.ja.schedule_for(L)
        self.offs = self.ja._offsets_for(L, self.mtm)
        self.kw = dict(genome_len=len(idx.genome.seq), offsets=self.offs,
                       lut_k=idx.lut_k, read_len=L)

    def packed(self, reads):
        r2b, nlist = pk.pack_reads_2bit(reads)
        return ((jnp.asarray(r2b), jnp.asarray(nlist)),
                (torch.from_numpy(r2b), torch.from_numpy(nlist)))


@pytest.fixture(scope="module", params=[100, 64])
def case(setup, request):
    return Case(setup[2], request.param)


def _eq(port, want):
    want = np.asarray(want)
    got = port.numpy() if isinstance(port, torch.Tensor) else port
    if want.dtype == np.uint32:
        want = want.astype(np.int64)    # the port's word carrier
    np.testing.assert_array_equal(got, want)


def test_device_tables_match_jax(setup, case):
    """gview, sa, lut, lut2 and lut4, each equal to the JAX aligner's."""
    for p, j in zip(case.p + (case.p4,), case.j + (case.j4,)):
        _eq(p, j)


@pytest.mark.parametrize("n_rate", [0.0, 0.002])
def test_planes_and_keys_match_jax(setup, case, n_rate):
    _, g, idx = setup
    reads = _reads(g, case.L, n_rate)
    (jr, jn), (pr, pn) = case.packed(reads)
    jp = jv4.words_from_2bit(jr, jn, case.L)
    pp = pv4.words_from_2bit(pr, pn, case.L)
    for p, j in zip(pp, jp):
        _eq(p, j)
    for w, b in ((0, 1), (2, 3)):
        kj, okj = jv4._keys_be(jp[w], jp[b], case.offs, idx.lut_k)
        kp, okp = pv4._keys_be(pp[w], pp[b], case.offs, idx.lut_k)
        _eq(kp, kj)
        _eq(okp, okj)


def test_cands_cores_match_jax(setup, case):
    _, g, _ = setup
    reads = _reads(g, case.L, 0.002, n=128)
    (jr, jn), (pr, pn) = case.packed(reads)
    jp = jv4.words_from_2bit(jr, jn, case.L)
    pp = pv4.words_from_2bit(pr, pn, case.L)
    gv, sa, _, lut2 = case.j
    pgv, psa, _, plut2 = case.p
    for nc, ns, cap in ((24, 12, None), (192, 96, None), (24, 12, 2)):
        want = jcore4(gv, sa, lut2, jnp.int32(0), jp, n_compact=nc,
                      n_extend=ns, max_per_bucket=cap, **case.kw)
        got = pv4._cands_core_v4(pgv, psa, plut2, pp, n_compact=nc,
                                 n_extend=ns, max_per_bucket=cap, **case.kw)
        for p, j in zip(got, want):
            _eq(p, j)
    want = jcore5(gv, case.j4, jnp.int32(0), jp, n_compact=24, n_extend=12,
                  **case.kw)
    got = pv5._cands_core_v5(pgv, case.p4, pp, n_compact=24, n_extend=12,
                             **case.kw)
    for p, j in zip(got, want):
        _eq(p, j)


@pytest.mark.parametrize("E", [512, 8])
def test_packed_passes_match_jax(setup, case, E):
    kind, g, _ = setup
    reads = _reads(g, case.L, 0.002)
    (jr, jn), (pr, pn) = case.packed(reads)
    kw = dict(n_compact=24, n_extend=12, max_tot_mm=case.mtm, mm_delta=1,
              tier2=(E, 192, 96), **case.kw)
    gv, sa, _, lut2 = case.j
    pgv, psa, _, plut2 = case.p
    w4 = jv4.fast_pass_packed_v4(gv, sa, lut2, jr, jn, **kw)
    w5 = jv5.fast_pass_packed_v5(gv, sa, lut2, case.j4, jr, jn, **kw)
    p4 = pv4.fast_pass_packed_v4(pgv, psa, plut2, pr, pn, **kw)
    p5 = pv5.fast_pass_packed_v5(pgv, psa, plut2, case.p4, pr, pn, **kw)
    assert p4.dtype == p5.dtype == torch.int32 and p5.shape == (B, 2)
    _eq(p4, w4)
    _eq(p5, w5)
    if kind == "repeats" and E == 8:    # leftover rows for the host ladder
        assert (p5[:, 0] == -3).sum() > 0


@pytest.mark.parametrize("nc,cap", [(512, None), (512, 4), (8192, 682)])
def test_fast_pass_matches_jax(setup, case, nc, cap):
    _, g, _ = setup
    reads = _reads(g, case.L, 0.002, n=64)
    gv, sa, lut, _ = case.j
    pgv, psa, plut, _ = case.p
    kw = dict(genome_len=case.kw["genome_len"], offsets=case.offs,
              lut_k=case.kw["lut_k"], n_compact=nc, max_ml=5,
              max_per_bucket=cap)
    want = jfast.fast_pass(gv, sa, lut, jnp.asarray(reads), **kw)
    got = pfast.fast_pass(pgv, psa, plut, torch.from_numpy(reads), **kw)
    assert got.keys() == want.keys()
    for key in want:
        _eq(got[key], want[key])


@pytest.mark.parametrize("use_v5", [None, False, True])
def test_align_batch_raw_matches_jax(setup, case, use_v5):
    kind, g, idx = setup
    reads = _reads(g, case.L, 0.002)
    ja = jk.KAligner(idx, batch_size=B, use_v5=use_v5)
    pa = pk.KAligner(idx, batch_size=B, use_v5=use_v5, device="cpu")
    want, got = ja.align_batch_raw(reads), pa.align_batch_raw(reads)
    for key in ("nar", "pos", "strand", "mm", "low_mm", "n_low",
                "overflow"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["max_tot_mm"] == want["max_tot_mm"]
    assert pa._lut4_decided == ja._lut4_decided
    assert (pa._lut4 is None) == (ja._lut4 is None)
    if kind == "repeats":
        assert (got["nar"] == 2).sum() > 0      # multi-loci reads
