"""The committed parallel golden (kit4b_tpu_torch/data/parallel_golden.npz),
which phase 20a of chip_smoke.py holds the port to on the card: its inputs
must be the ones `make_parallel_golden.workload()` rebuilds, and it must
hold every group's keys. The JAX package's outputs are held to it, and the
port's to both, in tests/test_torch_parallel.py (the sharded passes),
tests/test_torch_parallel_hammings.py (mesh and ring) and
tests/test_torch_parallel_sw_dist.py (SWService), each computing JAX's
side once.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on its 8-device virtual CPU mesh, about a minute):

    python tests/test_torch_parallel_golden.py [-o PATH]
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
    prev = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in prev:
        os.environ["XLA_FLAGS"] = (
            prev + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import make_parallel_golden as mg  # noqa: E402


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_inputs_are_the_workload(golden):
    assert str(golden["inputs_sha256"]) == mg.inputs_sha256(mg.workload())


@pytest.mark.parametrize("group", mg.GROUPS)
def test_golden_holds_every_key_of_each_group(golden, group):
    """The keys `compute` writes for a group, derived from its loops
    without running them."""
    work = mg.workload()
    want = set()
    shapes = {"key": mg.MESH_SHAPES, "pos": mg.MESH_SHAPES,
              "pe": mg.PE_SHAPES, "deep": mg.PE_SHAPES}
    if group == "key":
        want = {f"key:{v}:{dp}x{tp}:{f}" for v in ("v3", "v4", "v5")
                for dp, tp in shapes[group] for f in mg.FIELDS}
    elif group == "pos":
        want = {f"pos:se:{dp}x{tp}:{f}" for dp, tp in shapes[group]
                for f in mg.FIELDS}
    elif group in ("pe", "deep"):
        want = {f"{group}:rows:{dp}x{tp}" for dp, tp in shapes[group]}
    elif group in ("mesh", "ring"):
        for name, _, _, _, _, _, Ds, nodes in work["ham"]:
            want |= {f"{group}:{name}:D{D}" for D in Ds}
            if group == "mesh" and nodes > 1:
                want |= {f"mesh:{name}:D4:N{n + 1}of{nodes}"
                         for n in range(nodes)}
    else:
        want = {f"sw:score:D{D}" for D in mg.SW_DS} | {"sw:align:fields",
                                                     "sw:align:ops"}
    got = {k for k in golden if k.split(":")[0] == group}
    assert got == want


def main(argv=None) -> int:
    from torch_parallel_cases import jax_fns
    ap = argparse.ArgumentParser(
        description="Write the parallel golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    native.load()
    work = mg.workload()
    out = mg.compute(jax_fns(), work)
    out["inputs_sha256"] = np.array(mg.inputs_sha256(work))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"{args.out}: {len(out)} arrays, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    rc = main()
    print(f"{time.time() - t0:.1f} s")
    sys.exit(rc)
