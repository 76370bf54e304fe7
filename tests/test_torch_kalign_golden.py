"""The committed kalign golden (kit4b_tpu_torch/data/kalign_se_golden.npz),
which phase 8a of chip_smoke.py holds the port to on the card: regenerated
here through the JAX package it must equal the committed file, so it
cannot rot; and the port on the CPU must equal it too."""
import numpy as np
import pytest

from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.tools import make_kalign_golden as mg


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_regenerates_through_jax(golden):
    out = mg.jax_golden()
    assert sorted(out) == sorted(golden)
    for key, want in golden.items():
        np.testing.assert_array_equal(out[key], want, err_msg=key)
    # it exercises what phase 8a is there to hold: v5's tier 2 overflowing
    # its E slots, and the host ladder taking the rest
    assert int(golden["n_tier2_reads"]) > mg.E
    assert int(golden["n_ladder_reads"]) > 0
    assert set(np.unique(golden["nar"])) == {0, 1, 2, 3}


def test_port_on_cpu_matches_golden(golden, monkeypatch):
    g, idx, recs = mg.workload()
    assert mg.inputs_sha256(g, recs) == str(golden["inputs_sha256"])
    out = mg.compute(pk, idx, recs, device="cpu")
    monkeypatch.setattr(pk, "TIER2", None)      # tier 1 alone
    al = pk.KAligner(idx, batch_size=len(recs), use_v5=True, device="cpu")
    rows = al._submit(np.stack([r.codes for r in recs]))[1]
    out["n_tier2_reads"] = np.int64((rows[:, 0] == -3).sum())
    for key in golden:
        if key != "inputs_sha256":
            np.testing.assert_array_equal(out[key], golden[key],
                                          err_msg=key)
