"""The committed long-tail golden (kit4b_tpu_torch/data/longtail_golden.npz),
which phase 16a of chip_smoke.py holds the port to on the card: the small
keys regenerated here through the JAX package must equal the committed
file, so it cannot rot; the port on the CPU must equal them too, every
array exactly (blitz's small set gapped and ungapped, hrdx, kmerdist,
benchmark modes 0-4, alignsbs, ngsqc, maploci, rnade). The big blitz set
(`make_longtail_golden.blitz_big()`, 200 queries of 1-16 kbp) takes JAX
minutes on the CPU: its keys are held on the card only, and this file
checks here that the committed inputs are the ones `workload()` rebuilds.

Run as a script from the root of the repository, this file writes the
golden anew, the big set included (JAX on the CPU, minutes):

    python tests/test_torch_longtail_golden.py [-o PATH]
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
import torch  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import make_longtail_golden as mg  # noqa: E402


def jax_fns() -> SimpleNamespace:
    """The callables of `make_longtail_golden.compute()` through the JAX
    package's CLI on the CPU (with its compile cache left alone)."""
    from kit4b_tpu import cli
    from kit4b_tpu.utils import runtime

    def run(name, d):
        saved = runtime.enable_compile_cache
        runtime.enable_compile_cache = lambda: None
        try:
            return mg.run_cli(cli.main, name, d)
        finally:
            runtime.enable_compile_cache = saved
    return SimpleNamespace(run=run)


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def work():
    return mg.workload()


def _small(gold):
    return {k: v for k, v in gold.items()
            if not any(f":{r}:" in k for r in mg.BIG_RUNS)}


def test_golden_inputs_are_the_workload(golden, work):
    assert str(golden["inputs_sha256"]) == mg.inputs_sha256(work)
    big = [k for k in golden if any(f":{r}:" in k for r in mg.BIG_RUNS)]
    assert sorted(big) == ["cli:blitz_big_gapped:big_gapped.psl",
                           "cli:blitz_big_ungapped:big_ungapped.psl"]
    assert mg.check_reach(golden) == []


def test_golden_regenerates_through_jax(golden, work):
    out = mg.compute(jax_fns(), work)
    want = _small(golden)
    assert sorted(out) == sorted(want)
    for key, got in out.items():
        assert got.dtype == want[key].dtype, key
        np.testing.assert_array_equal(got, want[key], err_msg=key)


def test_port_on_cpu_matches_golden(golden, work):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = mg.compute(mg.port_fns("cpu"), work)
    finally:
        torch.set_num_threads(n)
    assert mg.differing(out, golden) == []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the long-tail golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = mg.compute(jax_fns(), big=True)
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
