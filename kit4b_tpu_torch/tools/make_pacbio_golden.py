"""The seeded inputs of the PacBio golden file and the arrays it holds: the
banded Smith-Waterman engine on its edge cases, and the four PacBio
commands' functions (`correct_reads`, `filter_reads`, `assemble`,
`polish_contigs`) on small readsets.

`kit4b_tpu_torch/data/pacbio_golden.npz` holds the JAX package's answers;
`python tests/test_torch_pacbio_golden.py` regenerates it (JAX on the CPU).
A machine without JAX rebuilds the same inputs with `sw_cases()` and
`workload()` (numpy and the port's own host modules), runs the port with
`compute(port_fns(device))` and compares with `differing()`: that is how
the port is held to the JAX package on the card.

The engine cases (`sw_cases()`), each a batch as `banded_sw_batch` takes
it: tests/test_pacbio.py:30's oracle case; paths along the band's first
and last index (k = 0 and W - 1) and one that drifts out of the band;
negative diagonals and one past the target; target lengths under the
array's width and a probe width that is no multiple of 512; lanes with
plen 0 (pad rows); N codes and 0x0F inside both sequences; two equal peaks
in one row and equal peaks in two rows; every score set the callers use
and one whose gap costs tie, (1, -1, -1, -1); bands of 1, 31, 100, 129,
1,025, 3,000, 4,096 and 4,097 (the scan kernel's 1, 2, 4 and 8 columns a
thread); walks longer than L_OPS = Lp + W, cut at it, and one saved by
the padding of Lp to 512; and a batch with `traceback=False`. `oracle`
marks the cases whose band holds the whole alignment (sw_oracle's score
is then the engine's; it scores N against N as a match, the engine not at
all). For each the file holds the
scan's best cell and pointer bytes, the traceback's outputs and the
alignments `banded_sw_batch` returns.
"""
from __future__ import annotations

import hashlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "pacbio_golden.npz"
SEED = 1212
PAD = 0x0F
# the callers' score sets: sswd's default, ecreads' and pbfilter's,
# pbassemb's, the JAX tests' and a tie of open and extend
SCORES = {"default": (1, -1, -3, -1), "ecreads": (1, -2, -2, -1),
          "pbassemb": (1, -3, -4, -2), "tests": (1, -1, -2, -1),
          "tie": (1, -1, -1, -1)}
# the alignment of each SWAlignment as int32 columns
ALN_FIELDS = ("score", "p_start", "p_end", "t_start", "t_end", "matches",
              "mismatches")


def mutate(rng, s, sub=0.05, ind=0.06) -> np.ndarray:
    """tests/test_pacbio.py's `_mutate`, drawing from `rng`."""
    out = []
    for b in s:
        r = rng.random()
        if r < ind / 2:
            continue
        if r < ind:
            out.extend([b, rng.integers(0, 4)])
        elif r < ind + sub:
            out.append((b + 1 + rng.integers(0, 3)) % 4)
        else:
            out.append(b)
    return np.array(out, np.uint8)


def _gappy(rng, a, W) -> np.ndarray:
    """`a` with 2 bases deleted and W + 1 random bases inserted, in an
    order that keeps the path inside a band of W on diagonal 0: its walk
    covers every probe row with W + 3 more ops than rows."""
    out, pos = [], 0
    for at, ev in zip(range(40, len(a) - 40, 40),
                      "IIDIDIIIIIII"[:W + 3]):
        out.append(a[pos:at])
        if ev == "I":
            out.append(rng.integers(0, 4, 1).astype(np.uint8))
            pos = at
        else:
            pos = at + 1
    out.append(a[pos:])
    return np.concatenate(out)


def _batch(label, pairs, Lp, Lt, diag0, band, scores="default",
           traceback=True, oracle=False) -> dict:
    """One engine case: `pairs` of (probe, target) code arrays written into
    [B, Lp] and [B, Lt] matrices padded with 0x0F."""
    B = len(pairs)
    probes = np.full((B, Lp), PAD, np.uint8)
    targets = np.full((B, Lt), PAD, np.uint8)
    plens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    for b, (p, t) in enumerate(pairs):
        probes[b, :len(p)] = p
        targets[b, :len(t)] = t
        plens[b], tlens[b] = len(p), len(t)
    return dict(label=label, probes=probes, plens=plens, targets=targets,
                tlens=tlens, diag0=np.asarray(diag0, np.int32), band=band,
                scores=SCORES[scores], traceback=traceback, oracle=oracle,
                pairs=pairs)


def sw_cases() -> list[dict]:
    """The engine's edge cases (module docstring), from numpy seeds."""
    cases = []
    # tests/test_pacbio.py:30, its module rng(11) fresh as when that file
    # runs in order
    rng, mrng = np.random.default_rng(3039), np.random.default_rng(11)
    pairs = []
    for _ in range(4):
        core = rng.integers(0, 4, 70).astype(np.uint8)
        p = np.concatenate([rng.integers(0, 4, 15), core,
                            rng.integers(0, 4, 15)]).astype(np.uint8)
        t = np.concatenate([rng.integers(0, 4, 20), mutate(mrng, core),
                            rng.integers(0, 4, 20)]).astype(np.uint8)
        pairs.append((p, t))
    cases.append(_batch("oracle", pairs, 100, 140, [10] * 4, 128,
                        oracle=True))

    rng = np.random.default_rng(SEED)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    # a path on k = 0, one on k = W-1, one drifting out of the band
    W = 64
    a, b2 = rand(300), rand(300)
    drift = np.concatenate([a[:100], rand(40), a[100:]])  # 40 inserted
    cases.append(_batch("band edges", [(a, a), (b2, b2), (a, drift)],
                        300, 340, [W // 2, W // 2 - (W - 1), 0], W))
    # diagonals below 0 and past the target
    a = rand(400)
    t = np.concatenate([rand(120), mutate(rng, a[:250], 0.03, 0.03)])
    cases.append(_batch("diag0 negative and past Lt",
                        [(a, t), (a, t), (a, a), (a, t)], 400, 400,
                        [-300, 400 + 50, -5, 90], 100))
    # tlen < Lt, Lp not a multiple of 512
    a = rand(700)
    cases.append(_batch(
        "tlen under Lt, Lp 700",
        [(a, mutate(rng, a[50:650], 0.02, 0.04)),
         (a[:650], mutate(rng, a[:640], 0.05, 0.05))], 700, 900,
        [50, 0], 129, scores="ecreads"))
    # lanes with plen 0: every row a pad row
    a = rand(300)
    cases.append(_batch("plen 0 lanes",
                        [(a, mutate(rng, a)), (a[:0], a), (a[:0], a[:0]),
                         (a[:150], mutate(rng, a[:150]))], 300, 320,
                        [0, 0, 0, 0], 31, scores="tests"))
    # N codes and 0x0F inside both sequences
    a = rand(260)
    t = mutate(rng, a, 0.03, 0.03)
    a2, t2 = a.copy(), t.copy()
    a2[[10, 11, 90, 200]] = 4
    t2[[10, 40, 41, 150]] = 4
    a2[120], t2[60] = PAD, PAD
    cases.append(_batch("N and 0x0F codes", [(a2, t2), (a2, a2), (t2, t2)],
                        260, 300, [0, 0, 0], 100))
    # two equal peaks in one row: the target holds the probe twice in band
    p = rand(20)
    t = np.concatenate([rand(5), p, rand(10), p, rand(5)])
    # equal peaks in two rows: the probe holds the target's unit twice
    u = rand(20)
    q = np.concatenate([u, rand(15), u])
    cases.append(_batch("equal peaks", [(p, t), (q, u)], 55, 60, [5, -20],
                        100, oracle=True))
    # gap costs that tie (open == ext), each caller's score set
    for name in ("tie", "ecreads", "pbassemb", "tests"):
        pairs = []
        for _ in range(3):
            a = rand(int(rng.integers(150, 260)))
            pairs.append((a, mutate(rng, a, 0.06, 0.12)))
        cases.append(_batch(f"scores {name}", pairs, 260, 300, [0, 2, -3],
                            64, scores=name, oracle=True))
    # band widths: the scan kernel's 1, 2, 4 and 8 columns a thread
    for W, n in ((1, 120), (31, 150), (100, 300), (129, 300), (1025, 500),
                 (3000, 600), (4096, 600), (4097, 520)):
        pairs = []
        for d in (0, 7):
            a = rand(n)
            pairs.append((a, np.concatenate([rand(d), mutate(rng, a)])))
        cases.append(_batch(f"W {W}", pairs, n, n + 40, [0, 7], W,
                            scores="tests" if W > 1000 else "default",
                            oracle=n <= 150 and W > 1))
    # walks longer than L_OPS = Lp + W: a probe that fills its padded
    # width is cut there; one of 500 is not, because the width of 500 is
    # padded to 512 (without the padding it would be)
    for label, n in (("L_OPS cut", 512), ("L_OPS padded", 500)):
        a = rand(n)
        cases.append(_batch(label, [(a, _gappy(rng, a, 8))], n, n + 16,
                            [4], 8, scores="tie"))
    a = rand(300)
    cases.append(_batch("traceback=False",
                        [(a, mutate(rng, a)), (a[:0], a)], 300, 330,
                        [0, 0], 64, traceback=False))
    return cases


def padded(case) -> tuple[np.ndarray, np.ndarray]:
    """The case's probes and targets padded to multiples of 512 with 0x0F,
    as banded_sw_batch pads them before the scan."""
    out = []
    for a in (case["probes"], case["targets"]):
        n = a.shape[1]
        m = -(-max(n, 1) // 512) * 512
        out.append(np.pad(a, ((0, 0), (0, m - n)), constant_values=PAD))
    return tuple(out)


def engine(fns, case) -> dict[str, np.ndarray]:
    """The scan, the traceback and banded_sw_batch of `fns` on one case:
    the scan's best cell and pointer bytes, the traceback's six arrays
    (the case's traceback=False skips both raw stages), and the
    alignments as ALN_FIELDS columns plus their ops as text."""
    W = case["band"]
    m, mm, go, ge = case["scores"]
    out = {}
    if case["traceback"]:
        probes, targets = padded(case)
        best, bi, bk, ptrs = fns.scan(
            probes, targets, case["plens"], case["tlens"], case["diag0"],
            W=W, match=m, mismatch=mm, gap_open=go, gap_ext=ge)
        out.update(best=best, bi=bi, bk=bk, ptrs=ptrs)
        tb = fns.traceback(ptrs, probes, targets, best, bi, bk,
                           case["diag0"], W=W,
                           L_OPS=probes.shape[1] + W)
        out.update(zip(("ops", "n", "ps", "ts", "nm", "nmm"), tb))
    alns = fns.banded(case["probes"], case["plens"], case["targets"],
                      case["tlens"], case["diag0"], band=W,
                      scores=fns.SWScores(m, mm, go, ge),
                      traceback=case["traceback"])
    out["aln"] = np.asarray([[getattr(a, f) for f in ALN_FIELDS]
                             for a in alns], np.int32)
    out["aln_ops"] = _text_array("\n".join(
        "".join(f"{op}{n}" for op, n in a.ops) for a in alns))
    return out


def _text_array(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), np.uint8).copy()


def records_array(records) -> np.ndarray:
    """A readset as one uint8 array: name, descr and codes of each
    record."""
    return np.frombuffer(b"".join(
        r.name.encode() + b"\t" + r.descr.encode() + b"\t"
        + np.asarray(r.codes, np.uint8).tobytes() + b"\n"
        for r in records), np.uint8).copy()


def workload() -> dict:
    """Small readsets of the four functions, as code arrays:
    `ecreads` 12 reads of 500 bp (2 % substitutions, 8 % InDels) from a
    1,500 bp genome; `pbfilter` a 400 bp arm folded on its reverse
    complement, the same with a 30 bp loop, a clean 900 bp read, a 120 bp
    read and a clean read with Ns; `pbassemb` 700 bp reads every 250 bp of
    2,400 bp (one reverse-complemented); `eccontigs` that genome with 15
    substitutions planted, polished with those reads."""
    rng = np.random.default_rng(SEED + 1)
    ref = rng.integers(0, 4, 1_500).astype(np.uint8)
    ec = [(f"r{i}", mutate(rng, ref[s:s + 500], 0.02, 0.08))
          for i, s in enumerate(rng.integers(0, 1_000, 12))]
    arm = rng.integers(0, 4, 400).astype(np.uint8)
    rc = np.where(arm[::-1] < 4, 3 - arm[::-1], arm[::-1]).astype(np.uint8)
    loop = rng.integers(0, 4, 30).astype(np.uint8)
    nread = rng.integers(0, 4, 700).astype(np.uint8)
    nread[rng.integers(0, 700, 12)] = 4
    filt = [("hp", np.concatenate([arm, rc])),
            ("hp_loop", np.concatenate([arm, loop, rc])),
            ("clean", rng.integers(0, 4, 900).astype(np.uint8)),
            ("short", rng.integers(0, 4, 120).astype(np.uint8)),
            ("withN", nread)]
    genome = rng.integers(0, 4, 2_400).astype(np.uint8)
    asm = [(f"c{i}", genome[s:s + 700].copy())
           for i, s in enumerate(range(0, 1_701, 250))]
    c3 = asm[3][1]
    asm[3] = ("c3", np.where(c3[::-1] < 4, 3 - c3[::-1], c3[::-1])
              .astype(np.uint8))
    dirty = genome.copy()
    pos = rng.choice(len(genome) - 100, 15, replace=False) + 50
    dirty[pos] = (dirty[pos] + 1) % 4
    return dict(ecreads=ec, pbfilter=filt, pbassemb=asm,
                polish=[("ctg", dirty)], genome=genome)


def inputs_sha256(cases, work) -> str:
    h = hashlib.sha256()
    for c in cases:
        for k in ("probes", "plens", "targets", "tlens", "diag0"):
            h.update(c[k].tobytes())
        h.update(repr((c["label"], c["band"], c["scores"],
                       c["traceback"])).encode())
    for k in ("ecreads", "pbfilter", "pbassemb", "polish"):
        for name, codes in work[k]:
            h.update(name.encode() + codes.tobytes())
    return h.hexdigest()


def compute(fns, cases=None, work=None) -> dict[str, np.ndarray]:
    """Every array of the golden through `fns` (`port_fns` here, the JAX
    package's in tests/test_torch_pacbio_golden.py)."""
    cases = sw_cases() if cases is None else cases
    work = workload() if work is None else work
    out = {"inputs_sha256": np.asarray(inputs_sha256(cases, work))}
    for c in cases:
        for k, v in engine(fns, c).items():
            out[f"sw:{c['label']}:{k}"] = v

    def recs(pairs):
        return [fns.SeqRecord(n, "", c) for n, c in pairs]
    out["ecreads"] = records_array(fns.correct_reads(
        recs(work["ecreads"]), fns.ECParams(
            min_read_len=300, min_corrected_len=200, band=256, batch=16)))
    filt, stats = fns.filter_reads(recs(work["pbfilter"]), fns.FilterParams(
        min_len=150, trim=5, batch=4))
    out["pbfilter"] = records_array(filt)
    out["pbfilter:stats"] = np.asarray(
        [stats[k] for k in ("in", "hairpins", "retained", "dropped_short")])
    seed = fns.ECParams(min_read_len=0, band=256, min_seed_cores=8)
    out["pbassemb"] = records_array(fns.assemble(
        recs(work["pbassemb"]), fns.AssembParams(min_overlap=300, band=256,
                                                 seed=seed)))
    out["eccontigs"] = records_array(fns.polish_contigs(
        recs(work["polish"]), recs(work["pbassemb"]),
        fns.ECParams(min_read_len=0, min_corrected_len=0, band=256,
                     min_seed_cores=8, batch=8)))
    return out


def port_fns(device) -> SimpleNamespace:
    """The callables of compute() through the port on `device`."""
    import torch

    from ..device import resolve
    from ..io.fasta import SeqRecord
    from ..kernels import sw
    from ..pacbio import ecreads, pbassemb, pbfilter, sswd
    dev = resolve(device)

    def up(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def scan(probes, targets, plens, tlens, diag0, **kw):
        best, bi, bk, ptrs = sw.sw_scan(*up(probes, targets, plens, tlens,
                                            diag0), **kw)
        return tuple(x.cpu().numpy() for x in (best, bi, bk, ptrs))

    def traceback(ptrs, probes, targets, best, bi, bk, diag0, **kw):
        res = sw.sw_traceback(*up(ptrs, probes, targets, best, bi, bk,
                                  diag0), **kw)
        return tuple(x.cpu().numpy() for x in res)

    def on_device(fn):
        def call(*a, **kw):
            return fn(*a, device=dev, **kw)
        return call

    return SimpleNamespace(
        scan=scan, traceback=traceback,
        banded=on_device(sswd.banded_sw_batch), SWScores=sswd.SWScores,
        SeqRecord=SeqRecord, ECParams=ecreads.ECParams,
        FilterParams=pbfilter.FilterParams,
        AssembParams=pbassemb.AssembParams,
        correct_reads=on_device(ecreads.correct_reads),
        filter_reads=on_device(pbfilter.filter_reads),
        assemble=on_device(pbassemb.assemble),
        polish_contigs=on_device(pbassemb.polish_contigs))


def check_reach(out: dict) -> list[str]:
    """The edges the golden is there to hold, each reached by its inputs;
    returns the ones missed."""
    def sw(label, key):
        return np.asarray(out[f"sw:{label}:{key}"])
    miss = []
    W = 64
    if list(sw("band edges", "bk")[:2]) != [0, W - 1]:
        miss.append("a peak on k = 0 and one on k = W - 1")
    if list(sw("equal peaks", "bk")) != [50, 70] \
            or list(sw("equal peaks", "bi")) != [19, 19]:
        miss.append("the first of two equal peaks, in one row and in two")
    if (sw("plen 0 lanes", "best")[1:3] != 0).any():
        miss.append("lanes of pad rows only")
    if sw("diag0 negative and past Lt", "best")[1] != 0:
        miss.append("a band past the target")
    if int(sw("L_OPS cut", "n")[0]) != 512 + 8:
        miss.append("a walk cut at L_OPS")
    if int(sw("L_OPS padded", "n")[0]) <= 500 + 8:
        miss.append("a walk longer than the unpadded Lp + W")
    ptr_bits = np.bitwise_or.reduce(np.concatenate(
        [sw(c, "ptrs").ravel() for c in ("scores tie", "oracle")]))
    if ptr_bits != 0x1F:
        miss.append(f"every pointer bit (seen {ptr_bits:#x})")
    stats = np.asarray(out["pbfilter:stats"])
    if stats[1] < 2 or stats[3] < 1:
        miss.append("pbfilter hairpins and a short subread")
    if np.asarray(out["ecreads"]).tobytes().count(b"\n") < 8:
        miss.append("eight corrected reads")
    contigs = np.asarray(out["pbassemb"]).tobytes()
    lens = [int(n) for n in re.findall(rb"\tlen=(\d+)", contigs)]
    if not lens or max(lens) <= 700:
        miss.append("a contig joined from several reads")
    return miss


def differing(out: dict, gold) -> list[str]:
    """Keys of the golden whose array `out` lacks or does not equal."""
    bad = [k for k in gold.keys() if k not in out]
    for k in gold.keys():
        if k in out:
            a, b = np.asarray(out[k]), gold[k]
            if a.shape != b.shape or a.dtype != b.dtype \
                    or not np.array_equal(a, b):
                bad.append(k)
    return sorted(set(bad))
