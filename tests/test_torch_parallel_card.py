"""The port's parallel paths on the card: the sharded passes, hammings -M
and -R and SWService on `[cuda:0] * D`, held to the committed JAX golden
(kit4b_tpu_torch/data/parallel_golden.npz) and to the same shard loops on
the CPU, with the kernels they launch counted. This file imports no jax,
so on a machine with a card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_parallel_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.kernels.minmm import minmm
from kit4b_tpu_torch.kernels.sw import sw_scan, sw_traceback
from kit4b_tpu_torch.tools import make_parallel_golden as mg

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def work(cuda):
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    return mg.workload()


@pytest.fixture(scope="module")
def golden():
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("group", mg.GROUPS)
def test_card_matches_golden_and_cpu(cuda, work, golden, group):
    launches = (minmm.launches, sw_scan.launches, sw_traceback.launches)
    on_card = mg.compute(mg.port_fns(cuda), work, groups=(group,))
    ran = (minmm.launches - launches[0], sw_scan.launches - launches[1],
           sw_traceback.launches - launches[2])
    assert mg.differing(on_card, golden, groups=(group,)) == []
    on_cpu = mg.compute(mg.port_fns("cpu"), work, groups=(group,))
    assert sorted(on_card) == sorted(on_cpu)
    for k in on_card:
        np.testing.assert_array_equal(on_card[k], on_cpu[k], err_msg=k)
    if group in ("mesh", "ring"):
        assert ran[0] > 0
    if group == "sw":
        assert ran[1] == sum(mg.SW_DS) + 1 and ran[2] == 1
