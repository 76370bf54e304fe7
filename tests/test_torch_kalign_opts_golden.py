"""The committed kalign options golden
(kit4b_tpu_torch/data/kalign_opts_golden.npz), which phase 13a of
chip_smoke.py holds the port to on the card: regenerated here through the
JAX package's CLI it must equal the committed file, so it cannot rot; and
the port's CLI on the CPU must equal it too. The raw BGZF bytes of the BAM,
BAI and CSI are compared only where this machine's zlib is the one that
wrote the golden; the decompressed payload and the decoded indexes always.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_kalign_opts_golden.py [-o PATH]
"""
import argparse
import os
import sys
import zlib
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg  # noqa: E402
from test_torch_kmarkers_card import few_threads  # noqa: E402,F401


def jax_golden() -> dict:
    from kit4b_tpu.cli import main
    w = mg.workload()
    out = mg.compute(main, [], *w)
    out["inputs_sha256"] = np.array(mg.inputs_sha256(*w))
    return out


def zlib_dependent(key: str, golden) -> bool:
    """Raw BGZF bytes, comparable only under the zlib that wrote them."""
    return key.endswith(":raw") and \
        str(golden["zlib_version"]) != zlib.ZLIB_RUNTIME_VERSION


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_regenerates_through_jax(golden):
    out = jax_golden()
    assert sorted(out) == sorted(golden)
    for key, got in out.items():
        if key == "zlib_version" or zlib_dependent(key, golden):
            continue
        np.testing.assert_array_equal(got, golden[key], err_msg=key)
    # every branch the golden is there to hold is reached
    assert mg.check_reach(golden) == []


def test_port_on_cpu_matches_golden(golden):
    w = mg.workload()
    assert mg.inputs_sha256(*w) == str(golden["inputs_sha256"])
    out = mg.compute(mg.port_main(), ["--device", "cpu"], *w)
    assert sorted(out) == sorted(k for k in golden if k != "inputs_sha256")
    for key, got in out.items():
        if key == "zlib_version" or zlib_dependent(key, golden):
            continue
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the kalign options golden through the JAX "
                    "package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    bad = mg.check_reach(out)
    if bad:
        raise SystemExit(f"the workload misses: {bad}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    for key in sorted(out):
        if key.endswith("stats.csv:text"):
            cls = [ln.split(",")[1:] for ln in str(out[key]).splitlines()
                   if ln.startswith('"classification"')]
            print(key.split(":")[0], {k.strip('"'): int(v) for k, v in cls})
    print(f"zlib {out['zlib_version']}; {args.out}: "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
