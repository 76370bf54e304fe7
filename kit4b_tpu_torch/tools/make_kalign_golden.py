"""The seeded workload of the kalign golden file and the arrays it holds.

`kit4b_tpu_torch/data/kalign_se_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_kalign_golden.py` regenerates it
(JAX on the CPU). A machine without JAX rebuilds the same inputs with
`workload()`, which uses numpy and the port's own host modules, runs the
port with `compute()` and compares: that is how the port is held to the JAX
package on the card.

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

import hashlib
import tempfile
from pathlib import Path

import numpy as np

from .. import dna
from ..align.kalign import TIER2
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome
from ..sim import simreads

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
    """(genome, index, reads as SeqRecords), seeded, through the port's
    host modules."""
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
