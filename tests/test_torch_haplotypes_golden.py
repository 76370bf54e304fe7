"""The committed haplotypes golden (kit4b_tpu_torch/data/haplotypes_golden.npz),
which phase 17a of chip_smoke.py holds the port to on the card: regenerated
here through the JAX package it must equal the committed file, so it
cannot rot; the port on the CPU must equal it too, every array exactly
(every mode of callhaplotypes, pbautils, snpmarkers, snps2pgsnps,
lochap2bed, markerseqs, repassemb, pangenome, seghaplotypes, gbsmapsnps
and dgts on `make_haplotypes_golden.workload()`).

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU, seconds):

    python tests/test_torch_haplotypes_golden.py [-o PATH]
"""
import argparse
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch.tools import make_haplotypes_golden as mg  # noqa: E402


def jax_fns() -> SimpleNamespace:
    """The callables of `make_haplotypes_golden.compute()` through the JAX
    package's CLI on the CPU."""
    from kit4b_tpu import cli
    return SimpleNamespace(run=lambda argv_t, d: mg.run_cli(cli.main,
                                                             argv_t, d))


@pytest.fixture(scope="module")
def golden():
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def work():
    return mg.workload()


def test_golden_inputs_are_the_workload(golden, work):
    assert str(golden["inputs_sha256"]) == mg.inputs_sha256(work)
    assert mg.check_reach(golden) == []
    runs = {k.split(":")[1] for k in golden if k != "inputs_sha256"}
    assert runs == set(mg.RUNS)


def test_golden_regenerates_through_jax(golden, work):
    out = mg.compute(jax_fns(), work)
    assert sorted(out) == sorted(golden)
    for key, got in out.items():
        assert got.dtype == golden[key].dtype, key
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def test_port_on_cpu_matches_golden(golden, work):
    assert mg.differing(mg.compute(mg.port_fns(), work), golden) == []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the haplotypes golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = mg.compute(jax_fns())
    bad = mg.check_reach(out)
    if bad:
        raise SystemExit(f"the workload misses: {bad}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"{args.out}: {len(out)} arrays, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    t0 = time.time()
    rc = main()
    print(f"{time.time() - t0:.1f} s")
    sys.exit(rc)
