"""The port's 32-bit word helpers (kit4b_tpu_torch/ops/bits.py) against
numpy's uint32 arithmetic and JAX's gathers and `.at[].set/add(mode=
"drop")`, exactly, on words with the top bit set."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu.ops.seed_extend_v4 import _bitrev2
from kit4b_tpu_torch.ops import bits

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
                 0xAAAAAAAA, 0x55555555, 0xF0000000], np.uint32)


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    x[:len(EDGE)] = EDGE
    assert (x >= 0x80000000).sum() > 1000
    return x


@pytest.mark.parametrize("s", [0, 1, 2, 7, 16, 30, 31, 32])
def test_shifts_match_uint32(words, s):
    t = bits.to_words(words)
    w = words.astype(np.uint64)
    want_r = (w >> s) if s < 32 else np.zeros_like(w)
    want_l = (w << s) & 0xFFFFFFFF
    np.testing.assert_array_equal(bits.shr32(t, s).numpy(), want_r)
    np.testing.assert_array_equal(bits.shl32(t, s).numpy(), want_l)
    # a per-element shift tensor, as the funnel shifts of the passes use
    st = torch.full_like(t, s)
    np.testing.assert_array_equal(bits.shl32(t, st).numpy(), want_l)
    np.testing.assert_array_equal((t >> st).numpy(), want_r)


def test_not_popcount_bitrev(words):
    t = bits.to_words(words)
    np.testing.assert_array_equal(bits.not32(t).numpy(), ~words)
    pc = np.array([bin(int(v)).count("1") for v in words])
    got = bits.popcount32(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pc)
    np.testing.assert_array_equal(bits.bitrev2(t).numpy(),
                                  np.asarray(_bitrev2(jnp.asarray(words))))
    np.testing.assert_array_equal(bits.bitrev2(bits.bitrev2(t)).numpy(),
                                  words)


@pytest.mark.parametrize("n", [1, 17])
def test_take_clamped_matches_jax_clipped_gather(n):
    table = np.arange(100, 100 + n, dtype=np.int32)
    idx = np.array([-5, -1, 0, n - 1, n, n + 40, 2 ** 30], np.int32)
    got = bits.take_clamped(torch.from_numpy(table), torch.from_numpy(idx))
    # the JAX passes clip before they gather (`sa[jnp.clip(i, 0, M - 1)]`)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx),
                               mode="clip"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.asarray(table)[jnp.clip(idx, 0, n - 1)]))


def test_scatter_set_drop_matches_jax():
    dst = np.arange(10, dtype=np.int32) * 3
    idx = np.array([2, 2 ** 30, -1, 9, 10, -11, 0], np.int32)
    vals = np.array([70, 71, 72, 73, 74, 75, 76], np.int32)
    want = np.asarray(jnp.asarray(dst).at[idx].set(vals, mode="drop"))
    got = bits.scatter_set_drop(torch.from_numpy(dst), torch.from_numpy(idx),
                                torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (10,)


def test_scatter_add_drop_2d_matches_jax():
    dst = np.zeros((4, 3), np.uint32)
    i0 = np.array([0, 1, 1, 3, 2 ** 30, -1, 4, 2], np.int32)
    i1 = np.array([0, 2, 2, 1, 0, 0, 0, 2 ** 30], np.int32)
    vals = np.array([1, 2, 4, 0x80000000, 8, 16, 32, 64], np.uint32)
    want = np.asarray(jnp.asarray(dst).at[i0, i1].add(jnp.asarray(vals),
                                                       mode="drop"))
    got = bits.scatter_add_drop_2d(bits.to_words(dst), torch.from_numpy(i0),
                                   torch.from_numpy(i1), bits.to_words(vals))
    np.testing.assert_array_equal(got.numpy(), want)
