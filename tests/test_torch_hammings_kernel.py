"""The port's offset-sweep hammings engine (kit4b_tpu_torch/kmer/
hammings_kernel.py, kernels/sweep.py) against the JAX package's
(kit4b_tpu/kmer/hammings_kernel.py), the numpy oracle and the port's
max-match engine, on the CPU.

Both packages get the same numpy inputs. The JAX side runs its Pallas
kernel in interpret mode, called directly as tests/test_hammings.py does
(the JAX dispatcher does not pass `interpret`). Every value is an integer,
so every comparison is exact (tolerance 0).
"""
import functools

import numpy as np
import pytest
import torch

from kit4b_tpu.kmer import hammings as jh
from kit4b_tpu.kmer import hammings_kernel as jk
from kit4b_tpu_torch.kernels.sweep import sweep_plain
from kit4b_tpu_torch.kmer import hammings as th
from kit4b_tpu_torch.kmer.hammings_kernel import hammings_exhaustive_kernel
from kit4b_tpu_torch.kmer.hammings_mxu import hammings_exhaustive_mxu

G = 1100


def _genome(n, seed):
    """Codes with an EOS, N bases (N == N matches), a forward and a
    reverse-complement near-copy, and EOG at the end."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 3] = 7                          # EOS chrom separator
    g[rng.integers(0, n, 6)] = 4           # N bases
    g[n // 2:n // 2 + 60] = g[40:100]      # forward copy: distance 0
    g[n // 2 + 20] = (g[n // 2 + 20] + 1) % 4   # ... and 1
    g[n - 120:n - 60] = np.where(g[219:159:-1] < 4, 3 - g[219:159:-1], 4)
    g[-1] = 0x0F                           # EOG
    return g


GENOME = _genome(G, seed=17)


def _orientation(g, which):
    """(own, partner, d_lo) of one of the JAX engine's four sweeps."""
    rc = np.where(g[::-1] < 4, 3 - g[::-1], g[::-1]).astype(np.uint8)
    grev = g[::-1].copy()
    return {"sense fwd": (g, g, 1), "sense rev": (grev, grev, 1),
            "anti fwd": (g, rc, 0),
            "anti rev": (grev, rc[::-1].copy(), 0)}[which]


@functools.cache
def _jax_engine(K, antisense):
    return jk.hammings_exhaustive_tpu(GENOME, K, antisense=antisense,
                                      tile=512, span=512, interpret=True)


@pytest.mark.parametrize("which", ["sense fwd", "sense rev", "anti fwd",
                                   "anti rev"])
@pytest.mark.parametrize("K", [7, 13, 25])
def test_sweep_plain_matches_pallas_interpret(K, which):
    own, part, d_lo = _orientation(GENOME, which)
    want = jk._run_sweep(part, own, K, G, d_lo, 512, 512, interpret=True)
    got = sweep_plain(torch.from_numpy(own), torch.from_numpy(part), K=K,
                      G_valid=G, d_lo=d_lo)
    assert got.dtype == torch.int32 and got.shape == (G,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("K", [7, 25])
def test_engine_matches_jax_pallas(K, anti):
    got = hammings_exhaustive_kernel(GENOME, K, antisense=anti, device="cpu")
    assert got.dtype == np.uint16 and got.shape == (G,)
    np.testing.assert_array_equal(got, _jax_engine(K, anti))
    assert int(got.min()) == 0


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("K", [7, 25])
def test_engine_matches_oracle(K, anti):
    g = _genome(400, seed=K + anti)
    np.testing.assert_array_equal(
        hammings_exhaustive_kernel(g, K, antisense=anti, device="cpu"),
        jh.hammings_oracle(g, K, antisense=anti))


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("K", [7, 13, 25])
def test_engine_matches_the_max_match_engine(K, anti):
    # the contract chip_smoke.py holds the two engines to on the card
    np.testing.assert_array_equal(
        hammings_exhaustive_kernel(GENOME, K, antisense=anti, device="cpu"),
        hammings_exhaustive_mxu(GENOME, K, antisense=anti, device="cpu",
                                T=256, S=128))


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("anti", [True, False])
def test_edge_lengths_match_jax(extra, anti):
    K = 9
    g = _genome(300, seed=2)[100:100 + K + extra]   # G = K and G = K + 1
    got = hammings_exhaustive_kernel(g, K, antisense=anti, device="cpu")
    want = jk.hammings_exhaustive_tpu(g, K, antisense=anti, tile=512,
                                      span=512, interpret=True)
    assert got.shape == want.shape == (K + extra,)
    np.testing.assert_array_equal(got, want)


def test_k_above_25_raises_as_in_jax():
    with pytest.raises(ValueError, match="K <= 25"):
        jk.hammings_exhaustive_tpu(GENOME, 26, interpret=True)
    with pytest.raises(ValueError, match="K <= 25"):
        hammings_exhaustive_kernel(GENOME, 26, device="cpu")


def test_g_below_k_matches_jax():
    g = GENOME[:5]
    assert hammings_exhaustive_kernel(g, 9, device="cpu").shape == (0,)
    assert jk.hammings_exhaustive_tpu(g, 9, interpret=True).shape == (0,)
    assert th.hammings_exhaustive(g, 9, legacy_sweep=True, use_kernel=True,
                                  device="cpu").shape == (0,)


@pytest.mark.parametrize("node,numnodes", [(0, 1), (1, 3), (2, 3)])
def test_dispatcher_ignores_node_split_as_in_jax(node, numnodes):
    # JAX's kernel path ignores node/numnodes: every node returns the whole
    # genome's minimum, so the merge of the nodes is that minimum too
    got = th.hammings_exhaustive(GENOME, 25, node=node, numnodes=numnodes,
                                 legacy_sweep=True, use_kernel=True,
                                 device="cpu")
    np.testing.assert_array_equal(got, _jax_engine(25, True))
