"""The seeded workload of the full-stats kalign golden file and the arrays
it holds.

`kit4b_tpu_torch/data/kalign_full_golden.npz` holds the JAX package's
answers on this workload; `python tests/test_torch_kalign_full_golden.py`
regenerates it (JAX on the CPU). A machine without JAX rebuilds the same
inputs with `workload()`, which uses numpy and the port's own host
modules, runs the port with `compute(port_fns(device))` and compares: that
is how the port's full-stats path is held to the JAX package on the card.

The workload (`repeat_genome()`, `workload()`): two chromosomes of 110
and 90 kbp with a 24 bp unit planted 600 times, in 12 islands of 50 copies
30 bp apart (reads there overflow tier 1 and the ladder's first tier, so
both ladder tiers run, and a mate there is found by the orphan rescue), a
300 bp unit planted 40 times (tier 1 overflows, the ladder's first tier
resolves), 16 introns with GT..AG sites and four N runs. Single-end reads:
simreads reads of 100 bp (Illumina-skewed 2 % substitutions, 15 % with one
InDel of 1-3 bp, 5' and 3' adapter artefacts at 5 % each, N bases at rate
0.004) and of 75 bp, 28 spliced reads (two reads on each of the first 12
introns, one on each of the last 4: orphans), 12 chimeric reads with
random flanks; paired ends of 2 x 100 bp whose mate 2 is cut to 72, 84 or
100 bp, as adapter trimming leaves mates, and 8 pairs whose mate 2 reads
into an N run (`_n_run_pairs`), which only the orphan rescue places.

The file holds, per rescue mode (`MODES`: -y 20, -l 10000, -C 50 and all
three): the nar/pos/strand/mm of every read from `align_records`, the
SHA-256 of the CIGARs and the count of CIGARs with each of I, D, N, S, the
orphan splice and microInDel demotions, the
SAM's SHA-256 (`write_sam`, unmapped records written); the reads of each
read length that tier 1 and the ladder's first tier leave overflowing
(`tiers`); `align_batch(return_raw=True)`'s hit lists on the first batch;
per pe mode 1-4, the PePair stream of the mixed-length pairs and the SHA-256
of `write_sam_fast`'s SAM; and the SHA-256 of the inputs.
"""
from __future__ import annotations

import hashlib
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome, SeqRecord
from ..sim import simreads
from .make_kalign_pe_golden import pair_fields

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "kalign_full_golden.npz"
SEED = 8088
BATCH = 256
MODES = {"y": dict(micro_indel=20), "l": dict(splice_max=10_000),
         "C": dict(chimeric_pct=50),
         "ylC": dict(micro_indel=20, splice_max=10_000, chimeric_pct=50)}
PE_MODES = (1, 2, 3, 4)
MIN_INS, MAX_INS = 150, 600
MATE2_LENS = (72, 84, 100)
N_PAIRS = 384
NAR = ("accepted", "nohit", "multi", "ns")   # the nar codes 0-3
RAW_KEYS = ("low_mm", "n_low", "nxt_mm", "hit_id", "hit_mm", "overflow")
CMDLINE = "kalign full golden"
INTRONS = 16          # planted on chr1 from INTRON0, 3.5 kbp apart
INTRON0 = 50_000
N_RUNS = ((0, 49_000, 60), (0, 108_000, 30), (1, 5_000, 40),
          (1, 80_000, 200))   # (chromosome, start, length)


def repeat_genome(seed: int = SEED):
    """The genome of the module docstring, and its introns as (exon 1
    end, intron length) in chr1 coordinates."""
    rng = np.random.default_rng(seed)
    c = [rng.integers(0, 4, n).astype(np.uint8) for n in (110_000, 90_000)]
    unit = rng.integers(0, 4, 24).astype(np.uint8)
    for i in range(600):              # 12 islands of 50 copies on chr2
        p = 8_000 + (i // 50) * 6_500 + (i % 50) * 30
        c[1][p:p + 24] = unit
    fam = rng.integers(0, 4, 300).astype(np.uint8)
    for i in range(40):               # exact copies, 1 kbp apart
        p = 5_000 + i * 1_000
        c[0][p:p + 300] = fam
    introns = []
    for i in range(INTRONS):
        don = INTRON0 + i * 3_500
        gap = 200 + i * 53
        c[0][don:don + 2] = (2, 3)                  # GT
        c[0][don + gap - 2:don + gap] = (0, 2)      # AG
        introns.append((don, gap))
    for ci, p, n in N_RUNS:
        c[ci][p:p + n] = dna.BASE_N
    g = Genome.from_records([SeqRecord(f"chr{i + 1}", "", s)
                             for i, s in enumerate(c)])
    return g, introns


def _spliced(g, introns, rng):
    """Reads across the introns: two on each of the first 12, one on each
    of the last 4 (orphan junctions)."""
    seq = g.seq
    recs = []
    for i, (don, gap) in enumerate(introns):
        for k in range(2 if i < 12 else 1):
            split = int(rng.integers(30, 71))
            r = np.concatenate([seq[don - split:don],
                                seq[don + gap:don + gap + 100 - split]])
            recs.append(SeqRecord(f"sj{i}_{k}|{don - split}|{split}|{gap}",
                                  "", r.astype(np.uint8)))
    return recs


def _chimeric(g, rng):
    recs = []
    for i in range(12):
        start = 20_000 + i * 1_500
        keep = 60 + (i * 5) % 30
        t5 = (i * 3) % (100 - keep)
        r = np.concatenate([rng.integers(0, 4, t5),
                            g.seq[start:start + keep],
                            rng.integers(0, 4, 100 - keep - t5)])
        recs.append(SeqRecord(f"ch{i}|{start}|{t5}", "", r.astype(np.uint8)))
    return recs


def _n_run_pairs(g):
    """Two pairs at each genome N run whose mate 2 reads 8 of the run's Ns
    (mate 1 forward upstream of it, then mate 1 reverse downstream): its
    seeds and extensions count the Ns as mismatches, so it has no hit, and
    the orphan rescue's scan, where an N matches an N, places it."""
    recs1, recs2 = [], []
    for ci, p, n in N_RUNS:
        p += int(g.starts[ci])
        for k, (a, b) in enumerate(((p - 92, p - 342), (p + n - 8,
                                                        p + n + 242))):
            m2 = g.seq[a:a + 100]
            m1 = g.seq[b:b + 100]
            if k == 0:
                m1, m2 = m1, dna.revcomp(m2)
            else:
                m1 = dna.revcomp(m1)
            recs1.append(SeqRecord(f"nrun{ci}_{p}_{k}/1", "", m1.copy()))
            recs2.append(SeqRecord(f"nrun{ci}_{p}_{k}/2", "", m2.copy()))
    return recs1, recs2


def workload():
    """(genome, index, single-end records, (mate-1 records, mate-2
    records)), seeded, through the port's host modules."""
    g, introns = repeat_genome()
    idx = SfxIndex.build(g)
    rng = np.random.default_rng(SEED + 1)
    se = simreads.sim_reads(g, simreads.SimParams(
        n_reads=700, read_len=100, seed=SEED + 2, error_mode="illumina",
        subs_rate=0.02, indel_rate=0.15, indel_size=3, artef5_rate=0.05,
        artef3_rate=0.05))
    for rec in se:
        ns = rng.random(len(rec.codes)) < 0.004
        rec.codes = np.where(ns, dna.BASE_N, rec.codes).astype(np.uint8)
    se = se + simreads.sim_reads(g, simreads.SimParams(
        n_reads=160, read_len=75, seed=SEED + 3, error_mode="illumina",
        subs_rate=0.02))
    se = se + _spliced(g, introns, rng) + _chimeric(g, rng)
    order = rng.permutation(len(se))
    se = [se[i] for i in order]
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=N_PAIRS, read_len=100, pe=True, pe_insert_min=MIN_INS,
        pe_insert_max=MAX_INS, error_mode="illumina", subs_rate=0.02,
        seed=SEED + 4))
    cut = rng.choice(MATE2_LENS, len(r2))
    for rec, n in zip(r2, cut):
        rec.codes = rec.codes[:n].copy()
    n1, n2 = _n_run_pairs(g)
    return g, idx, se, (r1 + n1, r2 + n2)


def inputs_sha256(g, se, pairs) -> str:
    h = hashlib.sha256(g.seq.tobytes())
    for rec in list(se) + list(pairs[0]) + list(pairs[1]):
        h.update(rec.name.encode())
        h.update(rec.codes.tobytes())
    return h.hexdigest()


def tier_counts(fns, al, recs) -> list[int]:
    """For each read length in order of first appearance, over its first
    BATCH reads: the reads tier 1 (`fast_pass_v3`) leaves overflowing,
    which climb to the ladder's first tier, and those that tier leaves
    overflowing, which climb to the second."""
    out = []
    for L in dict.fromkeys(len(r.codes) for r in recs):
        batch = [r for r in recs if len(r.codes) == L][:BATCH]
        arr = al._pad_batch(batch)
        ovf = fns.to_np(al._submit(arr, compact=False)["overflow"])
        rows = arr[:len(batch)][ovf[:len(batch)]]
        bt, nct = al.escalation[0]
        left = 0
        for s in range(0, len(rows), bt):
            sub = rows[s:s + bt]
            n = len(sub)
            sub = np.concatenate([sub, np.repeat(sub[:1], bt - n, axis=0)])
            left += int(fns.to_np(al._submit(
                sub, n_compact=nct, compact=False)["overflow"])[:n].sum())
        out += [L, len(rows), left]
    return out


def compute(fns, g, idx, se, pairs) -> dict:
    """The golden's arrays through one package: `fns` holds its kalign, pe
    and phases modules, its aligner factory and its device-to-numpy
    (`port_fns()`, or the JAX test's equivalent)."""
    kalign, phases = fns.kalign, fns.phases
    out = {}
    for mode, kw in MODES.items():
        al = fns.aligner(idx, **kw)
        aligned = list(al.align_records(se))
        res = [r for _, r in aligned]
        out[f"nar_{mode}"] = np.array([NAR.index(r.nar) for r in res],
                                      np.uint8)
        for key in ("pos", "strand", "mm"):
            out[f"{key}_{mode}"] = np.array([getattr(r, key) for r in res],
                                            np.int64)
        out[f"cigar_sha256_{mode}"] = np.array(hashlib.sha256("\n".join(
            r.cigar or "*" for r in res).encode()).hexdigest())
        out[f"n_cigar_{mode}"] = np.array(
            [sum(r.cigar is not None and op in r.cigar for r in res)
             for op in "IDNS"], np.int64)
        out[f"orphans_{mode}"] = np.array(
            [phases.remove_orphan_junctions(aligned, "splice")
             if "l" in mode else -1,
             phases.remove_orphan_junctions(aligned, "indel")
             if "y" in mode else -1], np.int64)
        with tempfile.TemporaryDirectory() as tmp:
            sam = Path(tmp) / "full.sam"
            kalign.write_sam(sam, idx, aligned, cmdline=CMDLINE)
            out[f"sam_sha256_{mode}"] = np.array(
                hashlib.sha256(sam.read_bytes()).hexdigest())
    al = fns.aligner(idx)
    out["tiers"] = np.array(tier_counts(fns, al, se), np.int64)
    first = al._pad_batch([r for r in se if len(r.codes) == 100][:BATCH])
    results, raw = al.align_batch(first, return_raw=True)
    out["raw_nar"] = np.array([NAR.index(r.nar) for r in results], np.uint8)
    for key in RAW_KEYS:
        out[f"raw_{key}"] = np.asarray(raw[key]).astype(
            bool if key == "overflow" else np.int64)
    for m in PE_MODES:
        pal = fns.pe.PeAligner(fns.aligner(idx), pair_min_len=MIN_INS,
                               pair_max_len=MAX_INS, pe_mode=m)
        fields = []

        def stream():
            for r1, r2, pp in pal.align_pairs(*pairs):
                fields.append(pair_fields(pp))
                yield r1, r2, pp
        with tempfile.TemporaryDirectory() as tmp:
            sam = Path(tmp) / "pe.sam"
            pal.write_sam_fast(sam, stream(), cmdline=CMDLINE)
            out[f"pe_sam_sha256_{m}"] = np.array(
                hashlib.sha256(sam.read_bytes()).hexdigest())
        out[f"pairs_{m}"] = np.array(fields, np.int64)
    return out


def port_fns(device="cuda"):
    """The callables of compute() through the port on `device`."""
    from ..align import kalign, pe, phases
    return SimpleNamespace(
        kalign=kalign, pe=pe, phases=phases,
        to_np=lambda t: t.cpu().numpy(),
        aligner=lambda idx, **kw: kalign.KAligner(
            idx, batch_size=BATCH, device=device, **kw))


def check_reach(out) -> list[str]:
    """What the workload must exercise, as messages for what it misses."""
    bad = []
    tiers = out["tiers"].reshape(-1, 3)
    if not (tiers[:, 1] > 0).all() or not (tiers[:, 2] > 0).any():
        bad.append(f"the ladder's tiers are not both reached: {tiers}")
    for mode in MODES:
        want = {"y": "ID", "l": "N", "C": "S"}
        n_cig = dict(zip("IDNS", out[f"n_cigar_{mode}"].tolist()))
        for op in "".join(want[k] for k in "ylC" if k in mode):
            if not n_cig[op]:
                bad.append(f"mode {mode}: no {op} CIGAR")
        orph = out[f"orphans_{mode}"]
        if ("l" in mode and orph[0] <= 0) or ("y" in mode and orph[1] <= 0):
            bad.append(f"mode {mode}: no orphan demotion {orph}")
    for m in PE_MODES:
        pairs = out[f"pairs_{m}"]
        if not pairs[:, 0].any():
            bad.append(f"pe mode {m}: no pair accepted")
        if m in (1, 3) and not (pairs[:, 10] > 0).any():
            bad.append(f"pe mode {m}: no rescued pair")
    if not (out["raw_nar"] == 2).any():
        bad.append("the raw batch holds no multi read")
    return bad
