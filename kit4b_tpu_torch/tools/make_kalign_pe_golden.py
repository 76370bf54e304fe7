"""The seeded workload of the paired-end kalign golden file and the arrays
it holds.

`kit4b_tpu_torch/data/kalign_pe_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_kalign_pe_golden.py` regenerates
it (JAX on the CPU). A machine without JAX rebuilds the same inputs with
`workload()`, which uses numpy and the port's own host modules, runs the
port with `compute(port_fns(device))` and compares: that is how the port is
held to the JAX package on the card.

The workload (`repeat_genome()`): two chromosomes of 120 and 80 kbp with 40
exact copies of a 300 bp unit, a 10 %-diverged 300 bp family of 160
copies, a 171 bp tandem array of 60 units, a 1.5 kbp block present twice,
a 600 bp segment present again reverse-complemented on the other
chromosome and five N runs; simulated pairs of 2 x 100 bp (2,048 pairs, two
batches of one superbatch group) and 2 x 150 bp (1,024 pairs), inserts 150
to 700, Illumina-skewed 2 % substitutions, N bases at rate 0.01 and 48
pairs whose mate 2 was swapped with a pair of the other chromosome;
aligned with -b 1024, -d 200, -D 600, in pe modes 1 and 2. Every
escalation stage is reached in each length and mode that has it.

The file holds, per read length L and mode m: the tier-1 pass's rows of
each batch (`rows_L`, unpack_rows12 layout; with the in-graph tier 2 and
without it, `rows_t1_L`), the pair rows each stage took (`stages_L_m`, in
STAGE_KEYS order, read off the aligner's own calls by `stage_spy`), the
PePair stream (`pairs_L_m`, PAIR_FIELDS columns) and the SHA-256 of the SAM
(-M 1, the SNP caller attached) and of the VCF; and the SHA-256 of the
inputs.
"""
from __future__ import annotations

import contextlib
import hashlib
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome, SeqRecord
from ..sim import simreads

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "kalign_pe_golden.npz"
SEED = 4242
READS = {100: 2048, 150: 1024}     # pairs of each read length
BATCH = 1024
MIN_INS, MAX_INS = 200, 600
MODES = (1, 2)
N_RATE = 0.01
N_SWAP = 48
MIN_SNP_READS = 2
CMDLINE = "kalign pe golden"
# the stages stage_spy reads off the aligner's calls, and the tier counts
# of the pass: rows sent to the in-graph tier 2, rows past it
STAGE_KEYS = ("tier2", "overflow", "rescue_before_deep", "deep1",
              "rescue_after_deep", "deep2b", "deep3", "orphan_rescue")
PAIR_FIELDS = ("accepted", "r1", "strand1", "pos1", "mm1", "r2", "strand2",
               "pos2", "mm2", "tlen", "rescued")


def repeat_genome(seed: int = SEED) -> Genome:
    """The repeat-dense two-chromosome genome of the module docstring."""
    rng = np.random.default_rng(seed)
    c = [rng.integers(0, 4, n).astype(np.uint8) for n in (120_000, 80_000)]
    fam = rng.integers(0, 4, 300).astype(np.uint8)
    for i in range(160):              # diverged family, both chromosomes
        s = c[i % 2]
        p = int(rng.integers(0, len(s) - 300))
        cp = fam.copy()
        at = rng.integers(0, 300, 30)
        cp[at] = (cp[at] + rng.integers(1, 4, 30)) % 4
        s[p:p + 300] = cp
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for i in range(40):               # exact copies, 2.9 kbp apart
        p = 1000 + i * 2900
        c[0][p:p + 300] = unit
    sat = rng.integers(0, 4, 171).astype(np.uint8)
    for i in range(60):               # tandem array
        p = 20_000 + i * 171
        c[1][p:p + 171] = sat
    c[1][50_000:51_500] = c[1][35_000:36_500]          # a block twice
    c[1][60_000:60_600] = dna.revcomp(c[0][70_000:70_600])
    for ci, p, n in ((0, 30_500, 150), (0, 90_000, 40), (1, 5_000, 40),
                     (1, 72_000, 500), (1, 79_900, 100)):
        c[ci][p:p + n] = dna.BASE_N
    return Genome.from_records([SeqRecord(f"chr{i + 1}", "", s)
                                for i, s in enumerate(c)])


def _reads(g: Genome, L: int, n: int, seed: int):
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=n, read_len=L, pe=True, pe_insert_min=150,
        pe_insert_max=700, error_mode="illumina", subs_rate=0.02,
        seed=seed))
    rng = np.random.default_rng(seed + 1)
    for rec in r1 + r2:
        ns = rng.random(L) < N_RATE
        rec.codes = np.where(ns, dna.BASE_N, rec.codes).astype(np.uint8)
    # mate 2 of N_SWAP chr1 pairs swapped with that of chr2 pairs: mates
    # on two chromosomes
    chrom = np.array([r.name.split("|")[2] for r in r1])
    a = np.nonzero(chrom == "chr1")[0][:N_SWAP]
    b = np.nonzero(chrom == "chr2")[0][:N_SWAP]
    for i, j in zip(a, b):
        r2[i], r2[j] = r2[j], r2[i]
    return r1, r2


def workload():
    """(genome, index, {L: (mate-1 records, mate-2 records)}), seeded,
    through the port's host modules; the reads come from the genome with
    SNPs planted at rate 0.002."""
    g = repeat_genome()
    idx = SfxIndex.build(g)
    mut, _ = simreads.simulate_snps(g, rate=0.002, seed=SEED + 7)
    return g, idx, {L: _reads(mut, L, n, SEED + L)
                    for L, n in READS.items()}


def inputs_sha256(g, reads) -> str:
    h = hashlib.sha256(g.seq.tobytes())
    for L in sorted(reads):
        for recs in reads[L]:
            for rec in recs:
                h.update(rec.name.encode())
                h.update(rec.codes.tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def stage_spy(pe_cls, counts: dict):
    """Counts the pair rows each escalation stage takes by wrapping the
    methods of a PeAligner class (either package's: the names are the
    same): deep calls by their groups (three groups: stage 1; one
    (False, True) group: stage 2b; one (True, True) group: stage 3) and
    insert-window scans by the method they run under (the orphan rescue,
    the deep tier's rescues, else the rescue before the deep tier)."""
    orig = {m: getattr(pe_cls, m) for m in
            ("_deep_submit", "_window_rescue", "_batch_rescue",
             "_deep_escalate")}
    inside = []

    def add(key, n):
        counts[key] = counts.get(key, 0) + int(n)

    def deep_submit(self, out, groups, kw):
        groups = tuple(groups)
        key = "deep1" if len(groups) == 3 else \
            "deep3" if groups[0][1] else "deep2b"
        add(key, sum(len(r) for r, _, _ in groups))
        return orig["_deep_submit"](self, out, groups, kw)

    def window_rescue(self, out, ridx, *a, **kw):
        add(inside[-1] if inside else "rescue_before_deep", len(ridx))
        return orig["_window_rescue"](self, out, ridx, *a, **kw)

    def under(name, key):
        def fn(self, *a, **kw):
            inside.append(key)
            try:
                return orig[name](self, *a, **kw)
            finally:
                inside.pop()
        return fn
    setattr(pe_cls, "_deep_submit", deep_submit)
    setattr(pe_cls, "_window_rescue", window_rescue)
    setattr(pe_cls, "_batch_rescue", under("_batch_rescue",
                                           "orphan_rescue"))
    setattr(pe_cls, "_deep_escalate", under("_deep_escalate",
                                            "rescue_after_deep"))
    try:
        yield counts
    finally:
        for m, f in orig.items():
            setattr(pe_cls, m, f)


def pair_fields(pp) -> list[int]:
    """A PePair as the PAIR_FIELDS integers (absent results read 0/-1)."""
    out = [int(pp.nar == "accepted")]
    for r in (pp.r1, pp.r2):
        out += [0, 0, -1, -1] if r is None else \
            [1, int(r.strand), int(r.pos), int(r.mm)]
    return out + [int(pp.tlen), int(pp.rescued)]


def port_fns(device="cuda"):
    """The callables of compute() through the port on `device`."""
    import torch

    from ..align import kalign, pe, snp
    from ..ops import pe_packed

    def tier1_rows(al, a1, a2, tier2, min_ins, max_ins):
        L = a1.shape[1]
        gview, sa, _, lut2 = al._device_for(L)
        _, mtm = al.schedule_for(L)
        g = al.index.genome
        up = [torch.from_numpy(x).to(al.device)
              for a in (a1, a2) for x in kalign.pack_reads_2bit(a)]
        rows = pe_packed.pe_pass_packed(
            gview, sa, lut2,
            torch.from_numpy(g.starts.astype(np.int32)).to(al.device), *up,
            genome_len=len(g.seq), offsets=al._offsets_for(L, mtm),
            lut_k=al.index.lut_k, read_len=L, n_compact=al.n_compact,
            n_extend=al.n_extend, max_ml=al.max_ml, max_tot=mtm,
            mm_delta=al.mm_delta, min_ins=min_ins, max_ins=max_ins,
            tier2=tier2, tier3=None)
        return pe_packed.unpack_rows12(rows.cpu().numpy())

    return SimpleNamespace(
        kalign=kalign, pe=pe, snp=snp, tier1_rows=tier1_rows,
        aligner=lambda idx: kalign.KAligner(idx, batch_size=BATCH,
                                            device=device))


def compute(fns, g, idx, reads, modes=MODES) -> dict:
    """The golden's arrays of the read lengths in `reads` and of `modes`
    through one package: `fns` holds its kalign, pe and snp modules, its
    aligner factory and its tier-1 pass (`port_fns()`, or the JAX test's
    equivalent)."""
    out = {}
    al = fns.aligner(idx)
    for L, (recs1, recs2) in reads.items():
        c1 = np.stack([r.codes for r in recs1])
        c2 = np.stack([r.codes for r in recs2])
        for tag, tier2 in (("rows", (BATCH, 192, 96)), ("rows_t1", None)):
            batches = []
            for i0 in range(0, len(c1), BATCH):
                a1, a2 = c1[i0:i0 + BATCH], c2[i0:i0 + BATCH]
                pad = BATCH - len(a1)
                if pad:
                    a1 = np.concatenate([a1, np.repeat(a1[:1], pad, 0)])
                    a2 = np.concatenate([a2, np.repeat(a2[:1], pad, 0)])
                batches.append(fns.tier1_rows(
                    al, a1, a2, tier2, MIN_INS,
                    MAX_INS)[:BATCH - pad])
            out[f"{tag}_{L}"] = np.concatenate(batches).astype(np.int32)
        for m in modes:
            pal = fns.pe.PeAligner(fns.aligner(idx), pair_min_len=MIN_INS,
                                   pair_max_len=MAX_INS, pe_mode=m)
            caller = fns.snp.SnpCaller(g, fns.snp.SnpOptions(
                min_snp_reads=MIN_SNP_READS))
            counts = {"tier2": int((out[f"rows_t1_{L}"][:, 5] == 3).sum()),
                      "overflow": int((out[f"rows_{L}"][:, 5] == 3).sum())}
            fields = []

            def stream():
                for r1, r2, pp in pal.align_pairs(recs1, recs2):
                    fields.append(pair_fields(pp))
                    yield r1, r2, pp
            with tempfile.TemporaryDirectory() as tmp, \
                    stage_spy(type(pal), counts):
                sam, vcf = Path(tmp) / "pe.sam", Path(tmp) / "pe.vcf"
                pal.write_sam_fast(sam, stream(), cmdline=CMDLINE,
                                   snp_caller=caller)
                fns.snp.write_snps_vcf(vcf, caller.call())
                out[f"sam_sha256_{L}_{m}"] = np.array(
                    hashlib.sha256(sam.read_bytes()).hexdigest())
                out[f"vcf_sha256_{L}_{m}"] = np.array(
                    hashlib.sha256(vcf.read_bytes()).hexdigest())
                out[f"n_vcf_lines_{L}_{m}"] = np.int64(
                    sum(not ln.startswith(b"#")
                        for ln in vcf.read_bytes().splitlines()))
            out[f"stages_{L}_{m}"] = np.array(
                [counts.get(k, 0) for k in STAGE_KEYS], np.int64)
            out[f"pairs_{L}_{m}"] = np.array(fields, np.int64)
    return out


def check_reach(out) -> list[str]:
    """What the workload must exercise, as messages for what it misses."""
    bad = []
    for L in READS:
        for m in MODES:
            st = dict(zip(STAGE_KEYS, out[f"stages_{L}_{m}"].tolist()))
            want = ["tier2", "overflow", "deep1", "deep3"]
            if m == 1:
                want += ["rescue_before_deep", "rescue_after_deep",
                         "deep2b", "orphan_rescue"]
            bad += [f"L {L} mode {m}: no {k}" for k in want if not st[k]]
            rows = out[f"rows_{L}"]
            if not (rows[:, 5] == 2).any():
                bad.append(f"L {L}: no PAIR_MULTI row")
            if not ((rows[:, 5] == 0) & (rows[:, 6] >= 0)
                    & (rows[:, 7] >= 0)).any():
                bad.append(f"L {L}: no pair of two unique mates rejected")
            pairs = out[f"pairs_{L}_{m}"]
            if m == 1 and not (pairs[:, 10] > 0).any():
                bad.append(f"L {L} mode {m}: no rescued pair")
            if not out[f"n_vcf_lines_{L}_{m}"]:
                bad.append(f"L {L} mode {m}: no SNP call")
    return bad
