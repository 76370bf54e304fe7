"""The committed kalign golden (kit4b_tpu_torch/data/kalign_se_golden.npz),
which phase 8a of chip_smoke.py holds the port to on the card: regenerated
here through the JAX package it must equal the committed file, so it
cannot rot; and the port on the CPU must equal it too.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_kalign_golden.py [-o PATH]
"""
import argparse
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.align import kalign as pk  # noqa: E402
from kit4b_tpu_torch.tools import make_kalign_golden as mg  # noqa: E402


def jax_golden() -> dict:
    """The golden arrays through the JAX package: its own Genome, SfxIndex
    and SeqRecords of `mg.workload()`'s inputs, its aligner and its v5
    pass."""
    import jax.numpy as jnp

    from kit4b_tpu.align import kalign as jk
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome, SeqRecord
    from kit4b_tpu.ops import seed_extend_v5
    pg, _, precs = mg.workload()
    g = Genome(list(pg.names), pg.starts, pg.lengths, pg.seq)
    idx = SfxIndex.build(g)
    recs = [SeqRecord(r.name, r.descr, r.codes, r.qual) for r in precs]
    out = mg.compute(jk, idx, recs)
    # reads escalated to tier 2: class -3 after the v5 tier 1 alone
    reads = np.stack([r.codes for r in recs])
    al = jk.KAligner(idx, batch_size=len(recs), use_v5=True)
    gview, sa, _, lut2 = al._device_for(mg.READ_LEN)
    _, mtm = al.schedule_for(mg.READ_LEN)
    r2b, nlist, _ = jk.pack_reads_2bit(reads)
    rows = seed_extend_v5.fast_pass_packed_v5(
        gview, sa, lut2, al._lut4_for(mg.READ_LEN, sa), jnp.asarray(r2b),
        jnp.asarray(nlist), genome_len=len(g.seq),
        offsets=al._offsets_for(mg.READ_LEN, mtm), lut_k=idx.lut_k,
        read_len=mg.READ_LEN, n_compact=al.n_compact, n_extend=al.n_extend,
        max_tot_mm=mtm, mm_delta=al.mm_delta, tier2=None)
    out["n_tier2_reads"] = np.int64((np.asarray(rows)[:, 0] == -3).sum())
    out["inputs_sha256"] = np.array(mg.inputs_sha256(g, recs))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the kalign golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    if not out["n_tier2_reads"] > mg.E or not out["n_ladder_reads"] > 0:
        raise SystemExit(f"the workload must overflow tier 2: "
                         f"{out['n_tier2_reads']} tier-2 reads, "
                         f"{out['n_ladder_reads']} ladder reads")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"{args.out}: {int(out['n_tier2_reads'])} tier-2 reads, "
          f"{int(out['n_ladder_reads'])} ladder reads, accepted "
          f"{int((out['nar'] == 0).sum())} of {len(out['nar'])}, SAM "
          f"sha256 {out['sam_sha256']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
