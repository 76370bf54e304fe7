"""The committed assembly golden (kit4b_tpu_torch/data/assembly_golden.npz),
which phase 14a of chip_smoke.py holds the port to on the card: regenerated
here through the JAX package's CLI and functions it must equal the
committed file, so it cannot rot; and the port's CLI with `--device cpu`
must equal it too. The float fields of `rnaexpr` are held within
`make_assembly_golden.R_TOL` (float32 rounding over 400 products, with
headroom), every other array exactly.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU); with `--full` it also runs config #5 at
BASELINE.md's size (1 Mbp at 25x) through the JAX package and stores the
SHA-256 of its outputs under `full:*`, which phase 14b holds the card to
(tier-1 compares only the small workload's keys):

    python tests/test_torch_assembly_golden.py [--full] [-o PATH]
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.tools import config5  # noqa: E402
from kit4b_tpu_torch.tools import make_assembly_golden as mg  # noqa: E402


def jax_fns():
    """The callables of mg.compute() through the JAX package; the SAMs
    that pescaffold reads come from the port's kalign on the CPU."""
    import jax.numpy as jnp

    from kit4b_tpu.align import rnaexpr
    from kit4b_tpu.assembly import assemble, filter as filt, overlap
    from kit4b_tpu.assembly.store import SeqStore
    from kit4b_tpu.cli import main
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import SeqRecord
    from kit4b_tpu.ops.extend_packed import pack_genome
    from kit4b_tpu.ops.seed_extend_fast import make_gview
    from kit4b_tpu_torch.cli import main as port_main

    def records(recs):
        return [SeqRecord(r.name, r.descr, r.codes, r.qual) for r in recs]

    def overlap_batch(store, cand=32):
        g, _ = overlap.corpus_genome(store, with_rc=False)
        idx = SfxIndex.build(g)
        n = min(mg.BATCH, len(g.names))
        qs = np.zeros(mg.BATCH, np.int64)
        ql = np.zeros(mg.BATCH, np.int64)
        qs[:n], ql[:n] = g.starts[:n], g.lengths[:n]
        win = int(g.lengths.max())
        nw2 = (win + 15) // 16 + 1
        gview = make_gview(*pack_genome(g.seq, nw2 + 1), nw2)
        pos, mm = overlap._overlap_pass(
            jnp.asarray(gview), jnp.asarray(g.seq),
            jnp.asarray(idx.sa_clean.astype(np.int32)),
            jnp.asarray(idx.lut.astype(np.int32)),
            jnp.asarray(g.starts.astype(np.int32)),
            jnp.asarray((g.starts + g.lengths).astype(np.int32)),
            jnp.asarray(qs), jnp.asarray(ql), lut_k=idx.lut_k, cand=cand,
            win=win)
        return np.asarray(pos), np.asarray(mm)

    def pearson(counts_csv):
        with tempfile.TemporaryDirectory() as tmp:
            p = Path(tmp) / "counts.csv"
            p.write_text(counts_csv)
            _, _, counts = rnaexpr.load_counts_matrix(p)
        return rnaexpr.pearson_matrix(counts)

    return SimpleNamespace(
        main=main, device=None, sam_main=port_main, sam_device="cpu",
        store_from_records=lambda a, b=None: SeqStore.from_records(
            records(a), None if b is None else records(b)),
        filter_assemble=lambda st: filt.filter_assemble(
            st, filt.FilterParams(),
            assemble.AssembleParams(**config5.ASSEMBLE_PARAMS)),
        merge_pe_to_se=assemble.merge_pe_to_se,
        overlap_batch=overlap_batch, pearson=pearson)


def jax_golden() -> dict:
    w = mg.workload()
    out = mg.compute(jax_fns(), *w)
    out["inputs_sha256"] = np.array(mg.inputs_sha256(*w))
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
    small = sorted(k for k in golden if not k.startswith("full:"))
    assert sorted(out) == small
    for key, got in out.items():
        np.testing.assert_array_equal(got, golden[key], err_msg=key)
    # every branch the golden is there to hold is reached
    assert mg.check_reach(golden) == []
    assert sorted(k for k in golden if k.startswith("full:")) == \
        sorted(f"full:{k}" for k in mg.FULL_KEYS)


def test_port_on_cpu_matches_golden(golden):
    w = mg.workload()
    assert mg.inputs_sha256(*w) == str(golden["inputs_sha256"])
    out = mg.compute(mg.port_fns("cpu"), *w)
    assert mg.differing(out, golden) == []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the assembly golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    ap.add_argument("--full", action="store_true",
                    help="also run config #5 at BASELINE.md's size "
                         "(minutes) and store its outputs' SHA-256")
    args = ap.parse_args(argv)
    out = jax_golden()
    bad = mg.check_reach(out)
    if bad:
        raise SystemExit(f"the workload misses: {bad}")
    if args.full:
        log = {}
        with tempfile.TemporaryDirectory() as tmp:
            out.update(mg.full_run(jax_fns(), Path(tmp),
                                   mg.timed_step(log))[0])
        print(f"full run ({mg.FULL_KBP} kbp at {mg.FULL_COV}x) through "
              f"the JAX package, seconds by step: {log}")
    elif Path(args.out).exists():     # keep the full run's keys
        with np.load(args.out) as z:
            out.update({k: z[k] for k in z.files if k.startswith("full:")})
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
