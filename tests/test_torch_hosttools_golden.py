"""The committed host-tools golden (kit4b_tpu_torch/data/hosttools_golden.npz),
which phase 19a of chip_smoke.py holds the port to on the card: regenerated
here through the JAX package it must equal the committed file, so it
cannot rot; the port on the CPU must equal it too, every array exactly
(every alignment-block, region, RAD-seq, loci-statistics, DNA-structure
and GO command, each mode and each flag that picks another code path, on
`make_hosttools_golden.workload()`: text byte for byte, a .npz array by
array). The runs whose answer rests on `np.argsort`'s order among equal
values (radseq's REF and ALT, prednucleosomes' dyad picks) are also run
with that order fixed both ways, so a host whose numpy breaks ties
otherwise still matches the golden.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU, seconds):

    python tests/test_torch_hosttools_golden.py [-o PATH]
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

from kit4b_tpu_torch.tools import make_hosttools_golden as mg  # noqa: E402


def jax_fns() -> SimpleNamespace:
    """The callables of `make_hosttools_golden.compute()` through the JAX
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
    cmds = {argv[0] for argv in mg.RUNS.values()}
    assert len(cmds) == 40


def test_golden_regenerates_through_jax(golden, work):
    out = mg.compute(jax_fns(), work)
    assert sorted(out) == sorted(golden)
    for key, got in out.items():
        assert got.dtype == golden[key].dtype, key
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def test_port_on_cpu_matches_golden(golden, work):
    assert mg.differing(mg.compute(mg.port_fns(), work), golden) == []


class _TiedNumpy:
    """numpy, but for `argsort`, which keeps equal values in index order
    ("first") or in reverse index order ("last")."""

    def __init__(self, order):
        self.order = order

    def __getattr__(self, name):
        return getattr(np, name)

    def argsort(self, a):
        a = np.asarray(a)
        if self.order == "first":
            return np.argsort(a, kind="stable")
        return len(a) - 1 - np.argsort(a[::-1], kind="stable")


@pytest.mark.parametrize("order", ["first", "last"])
def test_golden_does_not_rest_on_argsort_ties(golden, work, monkeypatch,
                                              order):
    """radseq picks a column's REF and ALT, and prednucleosomes its dyads,
    by `np.argsort`, whose order among equal values follows numpy's sort
    for the CPU it runs on (ROADMAP.md queue C); the golden's inputs hold
    no tie that moves an answer, so the answers stand with ties broken
    either way."""
    from kit4b_tpu_torch.assembly import radseq
    from kit4b_tpu_torch.tools import conformation
    for mod in (radseq, conformation):
        monkeypatch.setattr(mod, "np", _TiedNumpy(order))
    runs = {k: v for k, v in mg.RUNS.items()
            if v[0] in ("radseq", "prednucleosomes")}
    assert len(runs) == 6
    monkeypatch.setattr(mg, "RUNS", runs)
    out = mg.compute(mg.port_fns(), work)
    sub = {k: a for k, a in golden.items()
           if k == "inputs_sha256" or k.split(":")[1] in runs}
    assert mg.differing(out, sub) == []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the host-tools golden through the JAX package.")
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
