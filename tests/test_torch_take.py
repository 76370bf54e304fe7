"""The port's gather (kit4b_tpu_torch/kernels/take.py) and its profiler
(kit4b_tpu_torch/tools/profile_gather.py) against the JAX gather profiler
(tools/archive/profile_pallas_gather.py), on the CPU.

The JAX side is `jnp.take` and the profiler's own Pallas kernel
`kernel_take`, launched as `pallas_take` launches it but at small shapes and
in interpret mode. Both packages get the same numpy inputs, and every value
is an integer, so every comparison is exact (tolerance 0).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kit4b_tpu_torch import device as devmod
from kit4b_tpu_torch.kernels.take import FILL, take, take_plain
from kit4b_tpu_torch.tools import profile_gather

PROFILER = Path(__file__).resolve().parent.parent / "tools" / "archive" / \
    "profile_pallas_gather.py"


@pytest.fixture(scope="module")
def profiler():
    """The JAX profiler as a module. Loading it runs its profile once, at
    its full shapes, on the CPU (its Pallas half reports that the CPU needs
    interpret mode)."""
    spec = importlib.util.spec_from_file_location("profile_pallas_gather",
                                                  PROFILER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_take(kernel, table, idx, tile):
    """`pallas_take` of the profiler at the given shapes, interpreted."""
    T, N = table.shape[0], idx.shape[0]
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((N,), jnp.int32),
        grid=(N // tile,),
        in_specs=[pl.BlockSpec((T,), lambda k: (0,),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((tile,), lambda k: (k,),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tile,), lambda k: (k,),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(table, idx)


def _inputs(T, N, seed, out_of_range):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**31, T).astype(np.int32)
    if out_of_range:   # counted from the end, and past both ends
        idx = rng.integers(-2 * T, 2 * T, N).astype(np.int32)
        idx[:6] = [-1, -T, -T - 1, T, T + 5, -(2**31)]
    else:              # the profiler's draw: in range only
        idx = rng.integers(0, T, N).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("T,N,tile,out_of_range", [
    (4096, 8192, 1024, False),
    (1024, 4096, 512, True),
    (64, 256, 128, True),
])
def test_take_matches_jnp_take_and_pallas_interpret(profiler, T, N, tile,
                                                    out_of_range):
    table, idx = _inputs(T, N, seed=T, out_of_range=out_of_range)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(
        np.asarray(_pallas_take(profiler.kernel_take, jnp.asarray(table),
                                jnp.asarray(idx), tile)), want)
    got = take(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        take_plain(torch.from_numpy(table), torch.from_numpy(idx)).numpy(),
        want)
    if out_of_range:
        assert (want[2:6] == FILL).all()


def test_profiler_inputs_match_the_jax_tool(profiler):
    table, idx = profile_gather.inputs(torch.device("cpu"))
    assert (profile_gather.T, profile_gather.N) == (profiler.T, profiler.N)
    np.testing.assert_array_equal(table.numpy(), np.asarray(profiler.table))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(profiler.idx))
    # the tool's xla_gather equals the port's gather on its inputs
    np.testing.assert_array_equal(
        take(table, idx).numpy(),
        np.asarray(profiler.xla_gather(profiler.table, profiler.idx)))


def test_profiler_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(devmod.DeviceUnavailable):
        profile_gather.main()
