"""The host helpers the port re-homes from JAX-importing modules, held
byte-identical to their originals, and the port's own ctypes signatures of
the native symbols it calls. Tests of the native-backed packing skip when
the native library cannot be built (they never compare numpy with
numpy)."""
import ctypes

import numpy as np
import pytest
import torch

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.index import sa_build
from kit4b_tpu.ops import extend_packed as jep
from kit4b_tpu.ops import seed_extend_fast as jfast
from kit4b_tpu.ops import seed_extend_v3 as jv3
from kit4b_tpu.ops import seed_extend_v5 as jv5
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.ops import extend_packed as pep
from kit4b_tpu_torch.ops import seed_extend_fast as pfast
from kit4b_tpu_torch.ops import seed_extend_v3 as pv3
from kit4b_tpu_torch.ops import seed_extend_v5 as pv5


@pytest.fixture
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def test_native_signatures_declared_per_symbol(lib):
    P = ctypes.POINTER
    assert lib.pack2bit_u8.restype is ctypes.c_int64
    assert lib.pack2bit_u8.argtypes == [
        P(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, P(ctypes.c_uint8),
        P(ctypes.c_int32), ctypes.c_int64]
    assert lib.format_sam_se.restype is ctypes.c_int64
    assert lib.format_sam_se.argtypes == [
        ctypes.c_char_p, P(ctypes.c_int64), ctypes.c_char_p,
        P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_uint8), P(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    # the port's own handle: nothing is shared with the JAX loader's
    shared = sa_build._load_native()
    assert lib is not shared
    assert lib.pack2bit_u8 is not shared.pack2bit_u8


def test_missing_symbol_raises(monkeypatch, lib):
    monkeypatch.setitem(native.SIGNATURES, "no_such_symbol",
                        (ctypes.c_int, []))
    native.load.cache_clear()
    try:
        with pytest.raises(native.NativeUnavailable, match="no_such_symbol"):
            native.load()
    finally:
        monkeypatch.undo()
        native.load.cache_clear()


@pytest.mark.parametrize("L", [100, 64, 37])
@pytest.mark.parametrize("n_rate", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("B", [1, 300])
def test_pack_reads_2bit_matches_jax(lib, L, n_rate, B):
    """N rate 0.2 over 300 reads passes 4,096 Ns, so the N list grows."""
    rng = np.random.default_rng(L)
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[rng.random(reads.shape) < n_rate] = 4
    got = pk.pack_reads_2bit(reads)
    want = jk.pack_reads_2bit(reads)
    assert want[2]
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])


def test_pass_schedule_matches_jax():
    assert pk.SENS_MODES == jk.SENS_MODES
    assert pk.PassSpec.__dataclass_fields__.keys() == \
        jk.PassSpec.__dataclass_fields__.keys()
    for g in (1, 3, 4, 1000, 120_001, 4_600_001, 3 * 10 ** 9):
        for sens in jk.SENS_MODES:
            assert pk.auto_min_core_len(g, sens) == \
                jk.auto_min_core_len(g, sens)
    for L in (36, 64, 100, 150, 250):
        for subs in (0, 1, 5, 10, 80):
            for delta in (1, 2, 3):
                for sens in jk.SENS_MODES:
                    a = pk.build_pass_schedule(L, subs, delta, 4_600_001,
                                               sens)
                    b = jk.build_pass_schedule(L, subs, delta, 4_600_001,
                                               sens)
                    assert a[1] == b[1]
                    assert [tuple(vars(p).values()) for p in a[0]] == \
                        [tuple(vars(p).values()) for p in b[0]]


def test_window_helpers_match_jax():
    for L in (20, 36, 64, 100, 150):
        for k in (8, 11, 12, 13):
            for mm in (0, 1, 5, 9):
                offs = pfast.fast_offsets(L, k, mm)
                assert offs == jfast.fast_offsets(L, k, mm)
                nw = (L + 15) // 16
                for a, b in ((pfast._tail_mask(L, nw),
                              jfast._tail_mask(L, nw)),
                             (pfast._window_masks(offs, k, nw),
                              jfast._window_masks(offs, k, nw))):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000])
def test_pack_genome_and_gview_match_jax(n):
    rng = np.random.default_rng(n)
    seq = rng.integers(0, 4, n).astype(np.uint8)
    seq[rng.random(n) < 0.05] = 4
    seq[-1] = 0x0F
    for nw in (1, 65):
        got, want = pep.pack_genome(seq, nw), jep.pack_genome(seq, nw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for nw2 in (5, 8) if nw == 65 else ():
            a = pfast.make_gview_device(*got, nw2, torch.device("cpu"))
            b = jfast.make_gview(*want, nw2)
            assert a.dtype == torch.int64       # the port's word carrier
            np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))


def test_escalation_estimate_and_unpack_match_jax():
    rng = np.random.default_rng(3)
    for high in (0, 1, 50):
        cnt = rng.integers(0, 7, 4 ** 6)
        cnt[rng.choice(len(cnt), high, replace=False)] = 40
        lut = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
        for w in (1, 6, 12):
            assert pv5.host_escalation_estimate(lut, w) == \
                jv5.host_escalation_estimate(lut, w)
    assert pv5.host_escalation_estimate(np.zeros(5, np.int64), 6) == 0.0
    res = np.array([[12, 3], [-1, 2 ** 31 - 1], [-2, 1], [-3, 0], [0, 5]],
                   np.int32)
    for a, b in zip(pv3.unpack_result2(res), jv3.unpack_result2(res)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
