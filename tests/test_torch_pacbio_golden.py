"""The committed PacBio golden (kit4b_tpu_torch/data/pacbio_golden.npz),
which phase 15a of chip_smoke.py holds the port to on the card:
regenerated here through the JAX package it must equal the committed file,
so it cannot rot; and the port on the CPU must equal it too, every array
exactly (the engine's best cells, pointer bytes, walks and alignments on
`make_pacbio_golden.sw_cases()`, and the four functions' readsets).

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_pacbio_golden.py [-o PATH]
"""
import argparse
import os
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import make_pacbio_golden as mg  # noqa: E402
from torch_pacbio_cases import jax_fns  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_regenerates_through_jax(golden):
    out = mg.compute(jax_fns())
    assert sorted(out) == sorted(golden)
    for key, got in out.items():
        assert got.dtype == golden[key].dtype, key
        np.testing.assert_array_equal(got, golden[key], err_msg=key)
    assert mg.check_reach(golden) == []


def test_port_on_cpu_matches_golden(golden):
    out = mg.compute(mg.port_fns("cpu"))
    assert mg.differing(out, golden) == []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the PacBio golden through the JAX package.")
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
