"""The kalign golden file: the JAX package's answers on a seeded workload.

    python -m kit4b_tpu_torch.tools.make_kalign_golden [-o PATH]

writes `kit4b_tpu_torch/data/kalign_se_golden.npz` through kit4b_tpu's
aligner (jax on the CPU). A machine without jax rebuilds the same inputs
with `workload()`, which uses numpy and the jax-free host modules of
kit4b_tpu only, runs the port with `compute()` and compares: that is how
the port is held to the JAX package on the card.

The workload: a 200 kbp genome holding 30 copies of a 400 bp repeat and
five N runs, and 8,192 simulated 100 bp reads (simreads, Illumina-skewed
substitutions) with N bases at rate 0.002, aligned with the v5 tier 1
forced in one batch of 8,192. The repeat sends 1,913 reads to tier 2,
more than its E = 512 slots, so the leftover -3 rows climb the host ladder.
The file holds the tier-1 pass's [B, 2] rows, the nar/pos/strand/mm arrays
of `KAligner._collect_compact`, the SHA-256 of `write_sam_fast`'s SAM, the
tier-2 and ladder read counts, and the SHA-256 of the inputs.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..align.kalign import TIER2

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "kalign_se_golden.npz"
SEED = 31337
GENOME_LEN = 200_000
N_READS = 8192
READ_LEN = 100
N_RATE = 0.002
CMDLINE = "kalign golden"
E = TIER2[0]   # tier-2 read slots of the v5 pass


def workload():
    """(genome, index, reads as SeqRecords), seeded; no jax."""
    from kit4b_tpu import dna
    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.sim import simreads
    rng = np.random.default_rng(SEED)
    seq = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    unit = rng.integers(0, 4, 400).astype(np.uint8)
    for i in range(30):
        p = 2000 + i * 6500
        seq[p:p + 400] = unit
    for _ in range(5):
        p = int(rng.integers(0, GENOME_LEN - 300))
        seq[p:p + int(rng.integers(20, 300))] = dna.BASE_N
    seq = np.append(seq, dna.BASE_EOG).astype(np.uint8)
    g = Genome(["chr_golden"], np.array([0]), np.array([GENOME_LEN]), seq)
    idx = SfxIndex.build(g)
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=N_READS, read_len=READ_LEN, seed=SEED + 1,
        error_mode="illumina", subs_rate=0.02))
    ns = np.random.default_rng(SEED + 2).random((len(recs), READ_LEN)) \
        < N_RATE
    for rec, row in zip(recs, ns):
        rec.codes = np.where(row, dna.BASE_N, rec.codes).astype(np.uint8)
    return g, idx, recs


def inputs_sha256(g, recs) -> str:
    h = hashlib.sha256(g.seq.tobytes())
    for rec in recs:
        h.update(rec.name.encode())
        h.update(rec.codes.tobytes())
    return h.hexdigest()


def compute(kalign, idx, recs, **aligner_kw) -> dict:
    """The golden's arrays from an aligner module (kit4b_tpu.align.kalign
    or the port's), on one batch of every read with v5 forced."""
    reads = np.stack([r.codes for r in recs])
    al = kalign.KAligner(idx, batch_size=len(recs), use_v5=True,
                         **aligner_kw)
    dev = al._submit(reads)
    rows = dev[1]
    rows = np.array(rows.cpu() if hasattr(rows, "cpu") else rows)
    raw = al._collect_compact(dev, reads)
    with tempfile.TemporaryDirectory() as tmp:
        sam = Path(tmp) / "golden.sam"
        kalign.write_sam_fast(
            sam, idx, kalign.KAligner(idx, batch_size=len(recs),
                                      use_v5=True, **aligner_kw),
            recs, cmdline=CMDLINE)
        sam_sha = hashlib.sha256(sam.read_bytes()).hexdigest()
    return {"rows": rows.astype(np.int32),
            "nar": raw["nar"].astype(np.uint8),
            "pos": raw["pos"].astype(np.int64),
            "strand": raw["strand"].astype(np.int64),
            "mm": raw["mm"].astype(np.int64),
            "sam_sha256": np.array(sam_sha),
            "n_ladder_reads": np.int64((rows[:, 0] == -3).sum())}


def jax_golden() -> dict:
    """The golden arrays through kit4b_tpu (imports jax)."""
    import jax.numpy as jnp
    from kit4b_tpu.align import kalign
    from kit4b_tpu.ops import seed_extend_v5
    g, idx, recs = workload()
    out = compute(kalign, idx, recs)
    # reads escalated to tier 2: class -3 after the v5 tier 1 alone
    reads = np.stack([r.codes for r in recs])
    al = kalign.KAligner(idx, batch_size=len(recs), use_v5=True)
    gview, sa, _, lut2 = al._device_for(READ_LEN)
    _, mtm = al.schedule_for(READ_LEN)
    r2b, nlist, _ = kalign.pack_reads_2bit(reads)
    rows = seed_extend_v5.fast_pass_packed_v5(
        gview, sa, lut2, al._lut4_for(READ_LEN, sa), jnp.asarray(r2b),
        jnp.asarray(nlist), genome_len=len(g.seq),
        offsets=al._offsets_for(READ_LEN, mtm), lut_k=idx.lut_k,
        read_len=READ_LEN, n_compact=al.n_compact, n_extend=al.n_extend,
        max_tot_mm=mtm, mm_delta=al.mm_delta, tier2=None)
    out["n_tier2_reads"] = np.int64((np.asarray(rows)[:, 0] == -3).sum())
    out["inputs_sha256"] = np.array(inputs_sha256(g, recs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--out", default=str(GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    if not out["n_tier2_reads"] > E or not out["n_ladder_reads"] > 0:
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
