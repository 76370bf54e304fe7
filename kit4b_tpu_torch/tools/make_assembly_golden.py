"""The seeded workload of the assembly golden file and the arrays it holds:
config #5's commands (`filter`, `assemb`, `scaffold`, `pescaffold`,
`mergeoverlaps`), the fused `filter_assemble`, `merge_pe_to_se`, one
`_overlap_pass` batch, and the float commands `rnaexpr`, `genmlds` and
`sarscov2ml`.

`kit4b_tpu_torch/data/assembly_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_assembly_golden.py` regenerates
it (JAX on the CPU), and with `--full` also the SHA-256 of config #5's
outputs at BASELINE.md's size (`full_run`, keys `full:*`). A machine
without JAX rebuilds the same inputs with `workload()` (numpy and the
port's own host modules), runs the port with `compute(port_fns(device))`
and compares with `differing()`: that is how the port is held to the JAX
package on the card.

The workload (`workload()`): a 30 kbp genome with a 500 bp unit planted
twice, a 40 bp N run and a 20 bp unit 15 times in tandem; 1,600
simulated pairs of 2 x 100 bp (inserts 200-450), 40 short-insert pairs
whose mates overlap, 160 exact duplicate pairs, 30 pairs copied with one or
two substitutions in mate 1 (near duplicates), 5 random pairs (10 junk
reads) and 20 pairs read through a 40-90 bp fragment into the Illumina
adapters; every pair under one name, with seeded qualities (FASTQ).
Three contigs cut from the genome with gaps of 60 and 50 bp (the middle one
reverse-complemented) and an 80 bp random one, which pairs straddle; a
counts matrix of 12 samples in replicate pairs (two labels swapped) over
400 features with a partner CSV; a 300-isolate x 30-feature class matrix
with two planted linked groups.

The file holds, per command run (`RUNS`, the output file's name after the
colon): the SHA-256 of each output file; for `rnaexpr` the CSV's text,
compared within `R_TOL` (below); the arrays of the `assemb -P` checkpoint,
the fused route's contigs, `merge_pe_to_se`'s store and the pass's `(pos,
mm)`; the Pearson matrix `r` as float32; and the SHA-256 of the inputs.
"""
from __future__ import annotations

import hashlib
import math
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import dna
from ..io.fasta import Genome, SeqRecord, write_fasta, write_fastq
from ..sim import simreads
from . import config5

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "assembly_golden.npz"
SEED = 5105
GENOME_LEN = 30_000
REPEAT_LEN, REPEAT_AT = 500, (4_000, 19_000)
N_RUN = (25_000, 40)
TANDEM = (27_500, 20, 15)      # start, unit, copies: buckets past `cand`
L = 100
PAIRS, INSERT = 1_600, (200, 450)
SHORT_PAIRS, SHORT_INSERT = 40, (120, 190)
N_DUP, N_NEAR, N_JUNK, N_ADAPTER = 160, 30, 5, 20
# (start, end, reverse-complemented) of the scaffolding contigs
CONTIGS = ((0, 12_000, False), (12_060, 21_000, True),
           (21_050, 30_000, False))
TINY_CONTIG = 80
BATCH = 4096          # the one `_overlap_pass` batch's queries
COUNT_FEATURES = 400  # the rnaexpr counts matrix's features
# rnaexpr: the Pearson matrix is float32 rounding over F products; the
# port's r is held to JAX's within R_TOL absolute (headroom over the
# ~1e-7 relative rounding of a 400-term float32 dot product, and over the
# 6-decimal rounding of the CSV)
R_TOL = 1e-5
FULL_KBP, FULL_COV = 1000.0, 25.0    # BASELINE.md:47
# command runs, in order: name -> argv, with {d} the run's directory and {t}
# the parent of every run's directory; the port adds --device to the
# commands in DEVICE_CMDS
RUNS = {
    "filter": ["filter", "-i", "{d}/r1.fa", "-u", "{d}/r2.fa", "-o",
               "{d}/filt.fa"],
    "filter_a": ["filter", "-i", "{d}/a1.fa", "-u", "{d}/a2.fa", "-o",
                 "{d}/filt.fa", "-a"],
    "filter_D": ["filter", "-i", "{d}/r1.fa", "-u", "{d}/r2.fa", "-o",
                 "{d}/filt.fa", "-D", "2"],
    "filter_d": ["filter", "-i", "{d}/r1.fa", "-o", "{d}/filt.fa", "-d"],
    "filter_c": ["filter", "-i", "{d}/r1.fa", "{d}/r2.fa", "-o",
                 "{d}/filt.fa", "-c", "2", "-y", "80"],
    "filter_k": ["filter", "-i", "{d}/r1.fa", "-u", "{d}/r2.fa", "-o",
                 "{d}/filt.fa", "-k", "{d}/ck"],
    "assemb": ["assemb", "-i", "{t}/filter/filt.fa", "-o",
               "{d}/contigs.fa"],
    "assemb_pe": ["assemb", "-i", "{d}/r1.fa", "-u", "{d}/r2.fa", "-o",
                  "{d}/contigs.fa", "-y", "60", "-Y", "40", "-P", "2"],
    "mergeoverlaps": ["mergeoverlaps", "-i", "{d}/r1.fa", "-u", "{d}/r2.fa",
                      "-o", "{d}/merged.fa", "-j", "{d}/u1.fa", "-J",
                      "{d}/u2.fa"],
    "mergeoverlaps_q": ["mergeoverlaps", "-i", "{d}/r1.fq", "-u",
                        "{d}/r2.fq", "-o", "{d}/merged.fq", "-j",
                        "{d}/u1.fq", "-J", "{d}/u2.fq", "-y", "20", "-s",
                        "8"],
    "scaffold": ["scaffold", "-a", "{d}/r1.fa", "-A", "{d}/r2.fa", "-c",
                 "{d}/ctg.fa", "-o", "{d}/scaf.fa", "--minctg", "100"],
    "pescaffold": ["pescaffold", "-a", "{d}/m1.sam", "-A", "{d}/m2.sam",
                   "-c", "{d}/ctg.fa", "-o", "{d}/scaf.fa"],
    "rnaexpr": ["rnaexpr", "-i", "{d}/counts.csv", "-o", "{d}/out.csv"],
    "rnaexpr_c": ["rnaexpr", "-i", "{d}/counts.csv", "-c", "{d}/part.csv",
                  "-o", "{d}/out.csv"],
    "genmlds": ["genmlds", "-i", "{d}/counts.csv", "-l", "{d}/labels.csv",
                "-o", "{d}/out.csv"],
    "sarscov2ml": ["sarscov2ml", "-i", "{d}/mat.csv", "-o", "{d}/out.csv",
                   "-l", "3", "-r", "20", "-c", "3"],
}
DEVICE_CMDS = ("filter", "scaffold", "rnaexpr", "sarscov2ml", "kalign")
INPUTS = ("r1.fa", "r2.fa", "a1.fa", "a2.fa", "r1.fq", "r2.fq", "ctg.fa",
          "m1.sam", "m2.sam", "counts.csv", "part.csv", "labels.csv",
          "mat.csv")
ADAPTER_RUN_PAIRS = 600   # the -a run's share of the pairs (its trim is
#                           Python per read and start)


def genome() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    seq = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    unit = rng.integers(0, 4, REPEAT_LEN).astype(np.uint8)
    for p in REPEAT_AT:
        seq[p:p + REPEAT_LEN] = unit
    p, n = N_RUN
    seq[p:p + n] = dna.BASE_N
    p, u, n = TANDEM
    seq[p:p + u * n] = np.tile(rng.integers(0, 4, u).astype(np.uint8), n)
    return seq


def _pairs(seq, rng):
    """Mate-1 and mate-2 code arrays of every pair, in a seeded order."""
    g = Genome.from_records([SeqRecord("g", "", seq)])
    a, b = [], []
    for n, (lo, hi), s in ((PAIRS, INSERT, 1), (SHORT_PAIRS, SHORT_INSERT,
                                                2)):
        r1, r2 = simreads.sim_reads(g, simreads.SimParams(
            n_reads=n, read_len=L, pe=True, pe_insert_min=lo,
            pe_insert_max=hi, error_mode="illumina", subs_rate=0.005,
            seed=SEED + s))
        a += [r.codes for r in r1]
        b += [r.codes for r in r2]
    n0 = len(a)
    for i in rng.choice(n0, N_DUP):
        a.append(a[i].copy())
        b.append(b[i].copy())
    for i in rng.choice(n0, N_NEAR, replace=False):
        r = a[i].copy()
        at = rng.choice(L, 1 + i % 2, replace=False)
        r[at] = (r[at] + 1) % 4
        a.append(r)
        b.append(b[i].copy())
    for _ in range(N_JUNK):
        a.append(rng.integers(0, 4, L).astype(np.uint8))
        b.append(rng.integers(0, 4, L).astype(np.uint8))
    ad1 = dna.encode("AGATCGGAAGAGCACACGTCTGAACTCCAGTCA")
    ad2 = dna.encode("AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT")
    for _ in range(N_ADAPTER):
        m = int(rng.integers(40, 91))
        p = int(rng.integers(0, 24_000 - m))
        frag = seq[p:p + m]
        for out, f, ad in ((a, frag, ad1), (b, dna.revcomp(frag), ad2)):
            tail = rng.integers(0, 4, L).astype(np.uint8)
            out.append(np.concatenate([f, ad, tail])[:L].astype(np.uint8))
    order = rng.permutation(len(a))
    return [a[i] for i in order], [b[i] for i in order]


def _counts(rng):
    """(counts CSV text, partner CSV text): 12 samples in adjacent
    replicate pairs of distinct closeness, samples 2 and 5 swapped in the
    header, and 4 of the 400 features constant."""
    F, S = COUNT_FEATURES, 12
    base = rng.gamma(2.0, 50.0, size=(F, S // 2))
    cols = []
    for j in range(S // 2):
        noise = 0.05 + 0.04 * j
        for _ in range(2):
            cols.append(base[:, j] * np.exp(rng.normal(0, noise, F)))
    counts = np.round(np.stack(cols, 1), 1)
    counts[:4] = 7.0
    names = [f"S{i:02d}" for i in range(S)]
    names[2], names[5] = names[5], names[2]
    lines = ["Feature," + ",".join(f'"{n}"' for n in names)]
    lines += [f'"gene{f:04d}",' + ",".join(f"{v:g}" for v in counts[f])
              for f in range(F)]
    part = "".join(f"S{i:02d},S{i ^ 1:02d}\n" for i in range(S))
    return "\n".join(lines) + "\n", part


def _matrix(rng):
    """A class-value matrix CSV: 300 isolates x 30 features with values
    0-4, two planted groups of four features at >= 3 together in 60 and 45
    rows."""
    R, F = 300, 30
    m = rng.integers(0, 3, size=(R, F))
    for cols, n in (((2, 7, 11, 19), 60), ((4, 13, 22, 27), 45)):
        rows = rng.choice(R, n, replace=False)
        m[np.ix_(rows, cols)] = rng.integers(3, 5, size=(n, len(cols)))
    sprinkle = rng.random((R, F)) < 0.06
    m[sprinkle] = 3
    lines = ["Isolate," + ",".join(f"F{f:02d}" for f in range(F))]
    lines += [f"iso{r:03d}," + ",".join(str(int(v)) for v in m[r])
              for r in range(R)]
    return "\n".join(lines) + "\n"


def workload():
    """(genome codes, mate-1 records, mate-2 records, contig records,
    counts CSV, partner CSV, labels CSV, matrix CSV), seeded, through the
    port's host modules."""
    seq = genome()
    rng = np.random.default_rng(SEED + 7)
    a, b = _pairs(seq, rng)
    qrng = np.random.default_rng(SEED + 8)
    r1, r2 = ([SeqRecord(f"q{j + 1:05d}", "", c,
                         qrng.integers(2, 41, len(c)).astype(np.uint8))
               for j, c in enumerate(x)] for x in (a, b))
    ctg = []
    for i, (s, e, rc) in enumerate(CONTIGS):
        c = seq[s:e]
        ctg.append(SeqRecord(f"ctg{i + 1}", "", dna.revcomp(c) if rc
                             else c.copy()))
    ctg.append(SeqRecord("ctg_tiny", "", rng.integers(
        0, 4, TINY_CONTIG).astype(np.uint8)))
    counts, part = _counts(rng)
    labels = "".join(f"S{i:02d},{'AB'[i % 2]}\n" for i in range(12))
    return seq, r1, r2, ctg, counts, part, labels, _matrix(rng)


def inputs_sha256(seq, r1, r2, ctg, *texts) -> str:
    h = hashlib.sha256(seq.tobytes())
    for rec in list(r1) + list(r2) + list(ctg):
        h.update(rec.name.encode())
        h.update(rec.codes.tobytes())
        h.update(rec.qual.tobytes() if rec.qual is not None else b"-")
    for t in texts:
        h.update(t.encode())
    return h.hexdigest()


def _sha(b: bytes) -> np.ndarray:
    return np.array(hashlib.sha256(b).hexdigest())


def _store_arrays(key: str, st, n=None) -> dict:
    """A SeqStore's arrays, the concatenated codes as their SHA-256."""
    out = {f"{key}:{k}": getattr(st, k) for k in
           ("starts", "lengths", "flags")}
    out[f"{key}:seq"] = _sha(st.seq.tobytes())
    out[f"{key}:mate"] = st.mate if st.mate is not None \
        else np.zeros(0, np.int64)
    if n is not None:
        out[f"{key}:n"] = np.array(n)
    return out


def _fasta_sha(records) -> np.ndarray:
    h = hashlib.sha256()
    for r in records:
        h.update(f">{r.name}\n{dna.decode(r.codes)}\n".encode())
    return np.array(h.hexdigest())


def write_inputs(d: Path, r1, r2, ctg, counts, part, labels, mat) -> None:
    for m, recs in (("1", r1), ("2", r2)):
        fa = [SeqRecord(r.name, "", r.codes) for r in recs]
        write_fasta(d / f"r{m}.fa", fa)
        write_fasta(d / f"a{m}.fa", fa[:ADAPTER_RUN_PAIRS])
    write_fastq(d / "r1.fq", r1)
    write_fastq(d / "r2.fq", r2)
    write_fasta(d / "ctg.fa", ctg)
    for name, text in (("counts.csv", counts), ("part.csv", part),
                       ("labels.csv", labels), ("mat.csv", mat)):
        (d / name).write_text(text)


def _record_lengths(data: bytes) -> np.ndarray:
    """The lengths of a FASTA or FASTQ file's records."""
    lines = data.decode().splitlines()
    if lines and lines[0].startswith("@"):
        return np.array([len(s) for s in lines[1::4]], np.int64)
    out = []
    for ln in lines:
        if ln.startswith(">"):
            out.append(0)
        else:
            out[-1] += len(ln)
    return np.array(out, np.int64)


def summarize(run: str, d: Path) -> dict:
    """The golden's entries for one run's output directory."""
    out = {}
    for f in sorted(d.iterdir()):
        if f.name in INPUTS or ".kix" in f.name:
            continue
        key = f"{run}:{f.name}"
        if f.suffix == ".npz":      # checkpoints: zip timestamps differ
            with np.load(f) as z:
                for k in z.files:
                    out[f"{key}:{k}"] = _sha(z[k].tobytes()) if k == "seq" \
                        else z[k]
            continue
        data = f.read_bytes()
        out[key] = _sha(data)
        if f.suffix in (".fa", ".fq"):
            out[f"{key}:lengths"] = _record_lengths(data)
        if f.name == "scaf.fa":
            out[f"{key}:headers"] = np.array(
                [ln for ln in data.decode().splitlines()
                 if ln.startswith(">")])
        if run.startswith("rnaexpr"):
            out[f"{key}:text"] = np.array(data.decode())
    return out


def _run(main, argv, device, label):
    if device is not None and argv[0] in DEVICE_CMDS:
        argv = argv + ["--device", str(device)]
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{label}: {argv[0]} exited {rc}")


def compute(fns, seq, r1, r2, ctg, counts, part, labels, mat) -> dict:
    """The golden's arrays through one package: `fns.main` (its CLI's
    argv -> exit code) with `fns.device` (None: no --device flag),
    `fns.sam_main` / `fns.sam_device` for the SAMs that pescaffold reads,
    and the library calls `fns.store_from_records`, `fns.filter_assemble`,
    `fns.merge_pe_to_se`, `fns.overlap_batch` and `fns.pearson`."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for run, argv in RUNS.items():
            d = tmp / run
            d.mkdir()
            write_inputs(d, r1, r2, ctg, counts, part, labels, mat)
            if run == "pescaffold":
                kix = d / "ctg.kix"
                _run(fns.sam_main, ["index", "-i", str(d / "ctg.fa"), "-o",
                                    str(kix)], None, run)
                for m in "12":
                    _run(fns.sam_main, ["kalign", "-i", str(d / f"r{m}.fa"),
                                        "-I", str(kix), "-o",
                                        str(d / f"m{m}.sam"), "-b", "1024"],
                         fns.sam_device, run)
            argv = [a.replace("{d}", str(d)).replace("{t}", str(tmp))
                    for a in argv]
            _run(fns.main, argv, fns.device, run)
            if run == "filter_k":      # the run again resumes from -k
                (d / "filt.fa").rename(d / "filt0.fa")
                _run(fns.main, argv, fns.device, run)
            out.update(summarize(run, d))
    recs = [(SeqRecord(a.name, "", a.codes), SeqRecord(b.name, "", b.codes))
            for a, b in zip(r1, r2)]
    r1s, r2s = [a for a, _ in recs], [b for _, b in recs]
    contigs = fns.filter_assemble(fns.store_from_records(r1s, r2s))
    out["fused:contigs.fa"] = _fasta_sha(contigs.to_fasta_records("contig"))
    out.update(_store_arrays("fused", contigs))
    st, n = fns.merge_pe_to_se(fns.store_from_records(r1s, r2s))
    out.update(_store_arrays("merge_pe_to_se", st, n))
    pos, mm = fns.overlap_batch(fns.store_from_records(r1s + r2s))
    out["overlap_pass:pos"], out["overlap_pass:mm"] = pos, mm
    out["rnaexpr:r"] = fns.pearson(counts).astype(np.float32)
    return out


def port_fns(device="cuda"):
    """The callables of compute() through the port on `device`."""
    import torch

    from ..assembly import assemble, filter as filt, overlap
    from ..assembly.store import SeqStore
    from ..align import rnaexpr
    from ..cli import main
    from ..device import resolve
    from ..index.sfx_index import SfxIndex
    from ..ops.extend_packed import pack_genome
    from ..ops.seed_extend_fast import make_gview_device
    dev = resolve(device)

    def overlap_batch(store, cand=32):
        """One `_overlap_pass` over the store's live reads as
        `mark_near_duplicates` builds its inputs, on the first BATCH
        queries (zero-padded)."""
        g, _ = overlap.corpus_genome(store, with_rc=False)
        idx = SfxIndex.build(g)
        n = min(BATCH, len(g.names))
        qs = np.zeros(BATCH, np.int64)
        ql = np.zeros(BATCH, np.int64)
        qs[:n], ql[:n] = g.starts[:n], g.lengths[:n]
        win = int(g.lengths.max())
        nw2 = (win + 15) // 16 + 1
        gview = make_gview_device(*pack_genome(g.seq, nw2 + 1), nw2, dev)

        def t(x):
            return torch.from_numpy(x).to(dev)
        pos, mm = overlap._overlap_pass(
            gview, t(g.seq), t(idx.sa_clean.astype(np.int32)),
            t(idx.lut.astype(np.int32)), t(g.starts.astype(np.int32)),
            t((g.starts + g.lengths).astype(np.int32)), t(qs), t(ql),
            lut_k=idx.lut_k, cand=cand, win=win)
        return pos.cpu().numpy(), mm.cpu().numpy()

    def pearson(counts_csv):
        with tempfile.TemporaryDirectory() as tmp:
            p = Path(tmp) / "counts.csv"
            p.write_text(counts_csv)
            _, _, counts = rnaexpr.load_counts_matrix(p)
        return rnaexpr.pearson_matrix(counts, dev)

    return SimpleNamespace(
        main=main, device=str(dev), sam_main=main, sam_device=str(dev),
        store_from_records=SeqStore.from_records,
        filter_assemble=lambda st: filt.filter_assemble(
            st, filt.FilterParams(),
            assemble.AssembleParams(**config5.ASSEMBLE_PARAMS)),
        merge_pe_to_se=assemble.merge_pe_to_se,
        overlap_batch=overlap_batch, pearson=pearson)


def _rnaexpr_rows(text: str):
    rows = [ln.split(",") for ln in text.splitlines()[1:]]
    return [(r[0], r[1], float(r[2]), r[3], float(r[4]), float(r[5]),
             float(r[6]), r[7]) for r in rows]


def rnaexpr_close(got: str, want: str, n_feat: int) -> bool:
    """Two rnaexpr CSVs agree: the header, the sample, partner and best
    names and the Consistent column exactly; PartnerPearson and
    BestPearson within R_TOL (plus the CSV's 6-decimal rounding); Zobs and
    PValue within the bound that r's tolerance gives through the
    derivative of Fisher's z, sqrt(n - 3) / (1 - r^2) at the largest |r|
    of the interval (clipped at 0.999999 as `_fisher_z` clips), so near
    |r| = 1 the bound is wide, as the statistic is there."""
    if got.splitlines()[:1] != want.splitlines()[:1]:
        return False
    g_rows, w_rows = _rnaexpr_rows(got), _rnaexpr_rows(want)
    if len(g_rows) != len(w_rows):
        return False
    eps = R_TOL + 1e-6
    scale = math.sqrt(max(n_feat - 3, 1)) / math.sqrt(2.0)
    for g, w in zip(g_rows, w_rows):
        if (g[0], g[1], g[3], g[7]) != (w[0], w[1], w[3], w[7]):
            return False
        if abs(g[2] - w[2]) > eps or abs(g[4] - w[4]) > eps:
            return False
        dz = scale * sum(
            eps / (1 - min(abs(r) + eps, 0.999999) ** 2)
            for r in (w[2], w[4]))
        # z is rounded to 4 decimals, the p-value to 6; |d erfc(z/sqrt 2)
        # / dz| <= sqrt(2 / pi)
        if abs(g[5] - w[5]) > dz + 1e-4 or \
                abs(g[6] - w[6]) > math.sqrt(2 / math.pi) * (dz + 1e-4) \
                + 1e-6:
            return False
    return True


def differing(out: dict, golden) -> list[str]:
    """Keys of the golden's small workload whose value `out` does not
    match: every array equal, except the rnaexpr text (`rnaexpr_close`) and
    the float32 Pearson matrix (within R_TOL)."""
    bad = []
    keys = [k for k in golden if not k.startswith("full:")
            and k != "inputs_sha256"]
    for k in keys:
        if k not in out:
            bad.append(k)
        elif k.endswith(":text"):
            if not rnaexpr_close(str(out[k]), str(golden[k]),
                                 COUNT_FEATURES):
                bad.append(k)
        elif k == "rnaexpr:r":
            if out[k].shape != golden[k].shape or \
                    np.abs(out[k] - golden[k]).max() > R_TOL:
                bad.append(k)
        elif k.startswith("rnaexpr") and k.endswith("out.csv"):
            continue        # the text above holds it within tolerance
        elif not np.array_equal(out[k], golden[k]):
            bad.append(k)
    bad += [k for k in out if k not in golden]
    return bad


def check_reach(out) -> list[str]:
    """What the workload must exercise, as messages for what it misses."""
    bad = []
    for run in ("filter_D", "filter_d", "filter_c"):
        if out[f"filter:filt.fa"] == out[f"{run}:filt.fa"]:
            bad.append(f"{run} changes nothing")
    if not (out["filter_a:filt.fa:lengths"] < L).any() or \
            (out["filter:filt.fa:lengths"] < L).any():
        bad.append("-a trims no adapter")
    if out["filter_k:filt.fa"] != out["filter_k:filt0.fa"]:
        bad.append("the -k resume differs from the first run")
    if not any(k.startswith("assemb_pe:contigs.fa.pass2.npz") for k in out):
        bad.append("assemb -P 2 wrote no checkpoint")
    for run in ("scaffold", "pescaffold"):
        if not any("contigs=ctg1,ctg2,ctg3" in h
                   for h in out[f"{run}:scaf.fa:headers"]):
            bad.append(f"{run} does not join the three contigs")
    if int(out["merge_pe_to_se:n"]) == 0:
        bad.append("merge_pe_to_se merges nothing")
    pos = out["overlap_pass:pos"]
    if not ((pos != np.iinfo(np.int32).max).sum(1) == 32).any():
        bad.append("no query fills all 32 candidates")
    text = str(out["rnaexpr_c:out.csv:text"])
    if not any(ln.endswith(",0") for ln in text.splitlines()):
        bad.append("rnaexpr finds no inconsistent replicate")
    return bad


# --- config #5 at BASELINE.md's size ---------------------------------------

FULL_KEYS = ("filt.fa", "contigs.fa", "fused.fa", "pescaffolds.fa",
             "scaffolds.fa")


def full_run(fns, d: Path, step, kbp: float = FULL_KBP,
             cov: float = FULL_COV):
    """Config #5 through one package's CLI and fused route in directory d:
    `make_config5(kbp, cov)` as FASTA, then `filter`, `assemb -y 60 -Y
    40`, `index` of the contigs and `kalign` of each mate file onto them,
    `pescaffold`, `scaffold --minctg 100` and `filter_assemble` with
    config5_bacterial.py's parameters. Each step runs inside `step(name)`
    (a context manager; chip_smoke.py times them). Returns ({full:<file>:
    SHA-256} for FULL_KEYS, the genome's codes)."""
    from ..io.fasta import write_fasta as write
    seq, r1, r2 = config5.make_config5(kbp, cov)
    write(d / "r1.fa", r1)
    write(d / "r2.fa", r2)
    p = {k: str(d / k) for k in ("r1.fa", "r2.fa", "filt.fa", "contigs.fa",
                                 "contigs.kix", "m1.sam", "m2.sam",
                                 "pescaffolds.fa", "scaffolds.fa",
                                 "fused.fa")}
    steps = [
        ("filter", ["filter", "-i", p["r1.fa"], "-u", p["r2.fa"], "-o",
                    p["filt.fa"]]),
        ("assemb", ["assemb", "-i", p["filt.fa"], "-o", p["contigs.fa"],
                    "-y", "60", "-Y", "40"]),
        ("index", ["index", "-i", p["contigs.fa"], "-o", p["contigs.kix"]]),
        ("kalign r1", ["kalign", "-i", p["r1.fa"], "-I", p["contigs.kix"],
                       "-o", p["m1.sam"]]),
        ("kalign r2", ["kalign", "-i", p["r2.fa"], "-I", p["contigs.kix"],
                       "-o", p["m2.sam"]]),
        ("pescaffold", ["pescaffold", "-a", p["m1.sam"], "-A", p["m2.sam"],
                        "-c", p["contigs.fa"], "-o", p["pescaffolds.fa"]]),
        ("scaffold", ["scaffold", "-a", p["r1.fa"], "-A", p["r2.fa"], "-c",
                      p["contigs.fa"], "-o", p["scaffolds.fa"], "--minctg",
                      "100"]),
    ]
    for name, argv in steps:
        with step(name):
            _run(fns.main, argv, fns.device, name)
    with step("filter_assemble"):
        contigs = fns.filter_assemble(fns.store_from_records(
            [SeqRecord(r.name, "", r.codes) for r in r1],
            [SeqRecord(r.name, "", r.codes) for r in r2]))
        write(p["fused.fa"], contigs.to_fasta_records("contig"))
    return {f"full:{k}": _sha(Path(p[k]).read_bytes())
            for k in FULL_KEYS}, seq


def timed_step(log):
    """A `step` for full_run that records each step's wall seconds in
    log[name]."""
    @contextmanager
    def step(name):
        t0 = time.perf_counter()
        yield
        log[name] = time.perf_counter() - t0
    return step
