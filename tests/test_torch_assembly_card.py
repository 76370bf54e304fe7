"""Config #5's commands and the float device uses on the card: the
committed JAX golden (kit4b_tpu_torch/data/assembly_golden.npz) through
the port's CLI and functions on CUDA (`filter` with -D on the card,
`scaffold`'s kalign on the card, `rnaexpr` and `sarscov2ml`'s products on
the card; rnaexpr's floats within `make_assembly_golden.R_TOL`), and one
`_overlap_pass` batch on the card against the CPU. This file imports no
jax, so on a machine with a card it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_assembly_card.py -m cuda
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.assembly.store import SeqStore
from kit4b_tpu_torch.tools import make_assembly_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_workload_on_card_matches_golden(golden, cuda):
    w = mg.workload()
    assert mg.inputs_sha256(*w) == str(golden["inputs_sha256"])
    out = mg.compute(mg.port_fns(cuda), *w)
    assert mg.differing(out, golden) == []


@pytest.mark.cuda
def test_overlap_pass_on_card_matches_cpu(golden, cuda):
    _, r1, r2, *_ = mg.workload()
    store = SeqStore.from_arrays([r.codes for r in r1 + r2])
    got = mg.port_fns(cuda).overlap_batch(store, cand=8)
    want = mg.port_fns("cpu").overlap_batch(store, cand=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
