"""The committed paired-end kalign golden
(kit4b_tpu_torch/data/kalign_pe_golden.npz), which phase 11a of
chip_smoke.py holds the port to on the card: regenerated here through the
JAX package it must equal the committed file, so it cannot rot; and the
port on the CPU must equal it too, its own stage counters included.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_kalign_pe_golden.py [-o PATH]
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
from kit4b_tpu_torch.align import pe as ppe  # noqa: E402
from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg  # noqa: E402


def jax_inputs():
    """mg.workload()'s inputs as the JAX package's Genome, SfxIndex and
    SeqRecords."""
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome, SeqRecord
    pg, _, preads = mg.workload()
    g = Genome(list(pg.names), pg.starts, pg.lengths, pg.seq)
    reads = {L: tuple([SeqRecord(r.name, r.descr, r.codes, r.qual)
                       for r in recs] for recs in pair)
             for L, pair in preads.items()}
    return g, SfxIndex.build(g), reads


def jax_fns():
    """The callables of mg.compute() through the JAX package."""
    import jax.numpy as jnp

    from kit4b_tpu.align import kalign, pe, snp
    from kit4b_tpu.ops import pe_packed

    def tier1_rows(al, a1, a2, tier2, min_ins, max_ins):
        L = a1.shape[1]
        gview, sa, _, lut2 = al._device_for(L)
        _, mtm = al.schedule_for(L)
        g = al.index.genome
        up = [jnp.asarray(x) for a in (a1, a2)
              for x in kalign.pack_reads_2bit(a)[:2]]
        rows = pe_packed.pe_pass_packed(
            gview, sa, lut2, jnp.asarray(g.starts.astype(np.int32)), *up,
            genome_len=len(g.seq), offsets=al._offsets_for(L, mtm),
            lut_k=al.index.lut_k, read_len=L, n_compact=al.n_compact,
            n_extend=al.n_extend, max_ml=al.max_ml, max_tot=mtm,
            mm_delta=al.mm_delta, min_ins=min_ins, max_ins=max_ins,
            tier2=tier2, tier3=None)
        return pe_packed.unpack_rows12(np.asarray(rows))

    return SimpleNamespace(
        kalign=kalign, pe=pe, snp=snp, tier1_rows=tier1_rows,
        aligner=lambda idx: kalign.KAligner(idx, batch_size=mg.BATCH))


def jax_golden() -> dict:
    g, idx, reads = jax_inputs()
    out = mg.compute(jax_fns(), g, idx, reads)
    out["inputs_sha256"] = np.array(mg.inputs_sha256(g, reads))
    return out


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_workload():
    return jax_inputs()


CASES = [(L, m) for L in mg.READS for m in mg.MODES]


def test_golden_inputs_and_reach(golden, jax_workload):
    g, _, reads = jax_workload
    assert str(golden["inputs_sha256"]) == mg.inputs_sha256(g, reads) \
        == mg.inputs_sha256(*[mg.workload()[i] for i in (0, 2)])
    assert sorted(golden) == sorted(
        ["inputs_sha256"] + [f"{k}_{L}" for L in mg.READS
                             for k in ("rows", "rows_t1")]
        + [f"{k}_{L}_{m}" for L, m in CASES
           for k in ("stages", "pairs", "sam_sha256", "vcf_sha256",
                     "n_vcf_lines")])
    # every escalation branch the golden is there to hold is reached
    assert mg.check_reach(golden) == []


@pytest.mark.parametrize("L,mode", CASES)
def test_golden_regenerates_through_jax(golden, jax_workload, L, mode):
    g, idx, reads = jax_workload
    out = mg.compute(jax_fns(), g, idx, {L: reads[L]}, modes=(mode,))
    assert len(out) == 7
    for key, got in out.items():
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def test_port_on_cpu_matches_golden(golden):
    g, idx, reads = mg.workload()
    out = mg.compute(mg.port_fns("cpu"), g, idx, reads)
    assert sorted(out) == sorted(k for k in golden if k != "inputs_sha256")
    for key, got in out.items():
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


def test_port_stage_counters_match_the_spied_calls(golden):
    """The port's own PeAligner.stage_rows count what stage_spy reads off
    its calls, here on the 2 x 150 bp pairs in pe mode 1."""
    from kit4b_tpu_torch.align import kalign as pk
    g, idx, reads = mg.workload()
    pal = ppe.PeAligner(pk.KAligner(idx, batch_size=mg.BATCH,
                                    device="cpu"),
                        pair_min_len=mg.MIN_INS, pair_max_len=mg.MAX_INS,
                        pe_mode=1)
    with mg.stage_spy(ppe.PeAligner, {}) as spied:
        for _ in pal.align_pairs(*reads[150]):
            pass
    want = dict(zip(mg.STAGE_KEYS, golden["stages_150_1"].tolist()))
    assert pal.stage_rows["overflow"] == want["overflow"]
    for key in mg.STAGE_KEYS[2:]:
        assert pal.stage_rows[key] == want[key] == spied.get(key, 0), key


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the paired-end kalign golden through the JAX "
                    "package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    bad = mg.check_reach(out)
    if bad:
        raise SystemExit(f"the workload misses: {bad}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    for L in mg.READS:
        for m in mg.MODES:
            print(f"L {L} pe mode {m}: stages "
                  f"{dict(zip(mg.STAGE_KEYS, out[f'stages_{L}_{m}']))}, "
                  f"accepted {int(out[f'pairs_{L}_{m}'][:, 0].sum())} of "
                  f"{len(out[f'pairs_{L}_{m}'])}")
    print(f"{args.out}: {os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
