"""The committed full-stats kalign golden
(kit4b_tpu_torch/data/kalign_full_golden.npz), which phase 12a of
chip_smoke.py holds the port to on the card: regenerated here through the
JAX package it must equal the committed file, so it cannot rot; and the
port on the CPU must equal it too.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_kalign_full_golden.py [-o PATH]
"""
import argparse
import os
import sys
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import make_kalign_full_golden as mg  # noqa: E402
from test_torch_kmarkers_card import few_threads  # noqa: E402,F401


def jax_inputs():
    """mg.workload()'s inputs as the JAX package's Genome, SfxIndex and
    SeqRecords."""
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome, SeqRecord
    pg, _, se, pairs = mg.workload()
    g = Genome(list(pg.names), pg.starts, pg.lengths, pg.seq)

    def recs(rs):
        return [SeqRecord(r.name, r.descr, r.codes, r.qual) for r in rs]
    return g, SfxIndex.build(g), recs(se), tuple(recs(p) for p in pairs)


def jax_fns():
    """The callables of mg.compute() through the JAX package."""
    from kit4b_tpu.align import kalign, pe, phases
    return SimpleNamespace(
        kalign=kalign, pe=pe, phases=phases, to_np=np.asarray,
        aligner=lambda idx, **kw: kalign.KAligner(
            idx, batch_size=mg.BATCH, **kw))


def jax_golden() -> dict:
    g, idx, se, pairs = jax_inputs()
    out = mg.compute(jax_fns(), g, idx, se, pairs)
    out["inputs_sha256"] = np.array(mg.inputs_sha256(g, se, pairs))
    return out


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
        np.testing.assert_array_equal(got, golden[key], err_msg=key)
    # every branch the golden is there to hold is reached
    assert mg.check_reach(golden) == []


def test_port_on_cpu_matches_golden(golden):
    g, idx, se, pairs = mg.workload()
    assert mg.inputs_sha256(g, se, pairs) == str(golden["inputs_sha256"])
    out = mg.compute(mg.port_fns("cpu"), g, idx, se, pairs)
    assert sorted(out) == sorted(k for k in golden if k != "inputs_sha256")
    for key, got in out.items():
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the full-stats kalign golden through the JAX "
                    "package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    bad = mg.check_reach(out)
    if bad:
        raise SystemExit(f"the workload misses: {bad}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    for mode in mg.MODES:
        print(f"mode {mode}: accepted {int((out[f'nar_{mode}'] == 0).sum())}"
              f" of {len(out[f'nar_{mode}'])}, CIGARs with I, D, N, S "
              f"{out[f'n_cigar_{mode}'].tolist()}, orphans "
              f"{out[f'orphans_{mode}'].tolist()}")
    print(f"tiers {out['tiers'].tolist()}; pairs accepted "
          f"{[int(out[f'pairs_{m}'][:, 0].sum()) for m in mg.PE_MODES]}")
    print(f"{args.out}: {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
