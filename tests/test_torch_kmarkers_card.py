"""The kmarkers pass and restricted hammings on the card against the CPU,
and the pass on the CPU against the committed JAX golden. This file
imports no jax, so on a machine with a card it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_kmarkers_card.py

The `cuda` tests skip where there is no card."""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.kmer import hammings, kmarkers
from kit4b_tpu_torch.tools import make_kmarkers_golden as mg


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: the suite runs several workers on the machine's
    cores, and more threads per worker only contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def workload(golden):
    g, idx, cc, _ = mg.workload()
    return g, idx, cc, mg.tier1_batches(g, cc)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(workload, device, mh, n_compact=24, max_ml=48, batches=None):
    g, idx, cc, tier1 = workload
    tensors = (*kmarkers._fast_device_arrays(idx, mg.K, device),
               torch.from_numpy(g.seq).to(device),
               torch.from_numpy(g.starts.astype(np.int32)).to(device),
               torch.from_numpy(cc).to(device))
    return np.stack([kmarkers.kmarkers_pass(
        *tensors, torch.from_numpy(qp).to(device), K=mg.K,
        genome_len=len(g.seq),
        offsets=kmarkers.core_offsets(mg.K, mh, idx.lut_k), lut_k=idx.lut_k,
        n_compact=n_compact, max_ml=max_ml, min_hamming=mh,
        target=mg.TARGET).cpu().numpy() for qp in batches or tier1])


def test_pass_on_cpu_matches_golden_codes(golden, workload):
    assert mg.inputs_sha256() == str(golden["inputs_sha256"])
    np.testing.assert_array_equal(_codes(workload, "cpu", 2),
                                  golden["codes_e2"])


@pytest.mark.cuda
@pytest.mark.parametrize("mh", [1, 2, 3])
def test_pass_on_card_matches_cpu_and_golden(cuda, golden, workload, mh):
    got = _codes(workload, cuda, mh)
    np.testing.assert_array_equal(got, golden[f"codes_e{mh}"])
    np.testing.assert_array_equal(got, _codes(workload, "cpu", mh))


@pytest.mark.cuda
@pytest.mark.parametrize("n_compact,max_ml", [(256, 128), (2048, 512)])
def test_escalation_tiers_on_card_match_cpu(cuda, workload, n_compact,
                                            max_ml):
    """The positions of the tandem and poly-A runs at both tiers'
    capacities."""
    qp = [np.arange(26_000, 26_000 + 1024, dtype=np.int32)]
    got = _codes(workload, cuda, 2, n_compact, max_ml, qp)
    np.testing.assert_array_equal(
        got, _codes(workload, "cpu", 2, n_compact, max_ml, qp))
    assert (got >= 2).any()


@pytest.mark.cuda
def test_markers_on_card_match_golden(cuda, golden, workload):
    g, idx, cc, _ = workload
    stats = {}
    markers = kmarkers.find_cultivar_markers(
        idx, cc, mg.TARGET, kmer_len=mg.K, min_hamming=2, batch=mg.BATCH,
        device=cuda, stats=stats)
    np.testing.assert_array_equal(
        np.array([(g.names.index(m.chrom), m.start, m.length)
                  for m in markers]), golden["markers_m1_e2"])
    assert [stats[k] for k in ("tier1", "tier2", "tier3", "dropped")] == \
        golden["tiers_e2"].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in mg.restricted_cases()])
def test_restricted_on_card_matches_golden(cuda, golden, case):
    _, g, lut_k, K, mh, batch = next(c for c in mg.restricted_cases()
                                     if c[0] == case)
    got = hammings.hammings_restricted(SfxIndex.build(g, lut_k), K,
                                       max_hamming=mh, batch=batch,
                                       device=cuda)
    np.testing.assert_array_equal(got, golden[f"restricted_{case}"])
