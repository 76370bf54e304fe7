"""The cases built to break csrc/sw.cu's cluster scan and tiled walk
(kit4b_tpu_torch/tools/sw_cluster_cases.py) through the port's plain
versions (kernels/sw.py) and the JAX package's `_sw_scan`,
`_traceback_dev` and `banded_sw_batch` (kit4b_tpu/pacbio/sswd.py) on the
CPU, exactly, as tests/test_torch_sswd.py holds the golden's cases: the
best cell, the whole [Lp, B, W] pointer array, the walk's six arrays and
every field of every alignment. The walks over random pointer bytes are
held to `_traceback_dev` on the same bytes.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.tools import make_pacbio_golden as mg
from kit4b_tpu_torch.tools.sw_cluster_cases import cluster_cases, \
    random_pointer_cases
from torch_pacbio_cases import jax_fns

CASES = {c["label"]: c for c in cluster_cases()}
RANDOM = {c["label"]: c for c in random_pointer_cases()}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("label", list(CASES))
def test_cluster_case_matches_jax(label):
    case = CASES[label]
    want = mg.engine(jax_fns(), case)
    got = mg.engine(mg.port_fns("cpu"), case)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("label", list(RANDOM))
def test_walk_over_random_bytes_matches_jax(label):
    c = RANDOM[label]
    args = [c[k] for k in ("ptrs", "probes", "targets", "best", "bi", "bk",
                           "diag0")]
    want = jax_fns().traceback(*args, W=c["W"], L_OPS=c["L_OPS"])
    got = sw.traceback_plain(*(torch.from_numpy(a) for a in args), W=c["W"],
                             L_OPS=c["L_OPS"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
