#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kit4b_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package kit4b_tpu. Each phase
raises on failure, and the script then exits non-zero without printing a
result:

1. The card's name and power limit (nvidia-smi), the CUDA version, and the
   build of the three kernels (csrc/minmm.cu, sweep.cu, take.cu; one nvcc
   each, all at once) with ptxas's report; minmm must not spill.
2. The min-match kernel against its plain PyTorch version at the shapes
   of phase 4's run (Cw = 128, T = 2048, S = 1024, one row chunk of 2^21
   own rows against the node's partner spans), bit for bit, and at a
   shorter span with diag on and off, a non-zero row_base and span_lo > 0;
   then wide rows (K 51 and 153: Cw 256 and 768) and R = 384 (not a
   multiple of the kernel's 256 own rows). The first case timed with CUDA
   events, with its share of the int8 bound; then every width the kernel
   is built for (Cw 128-768) timed on 131,072 own rows against 262,144
   partner columns (`kit4b_tpu_torch.tools.time_minmm`), each beside its
   bound.
3. `hammings_exhaustive_mxu` on the card against the numpy oracle on a
   2 kbp seeded genome with N bases and an EOS, K 7 and 25, antisense on
   and off: exact equality.
4. The CLI end to end: `hammings -K 25 -n NUMNODES -N 1` on a seeded
   synthetic genome with the 16 nuclear chromosome lengths of
   S. cerevisiae R64 (12,071,326 bp), with planted near-copies and N runs.
   The .hmg is read back and checked at 2,000 random and 500 planted
   positions against a direct on-card computation of the node's partial
   minimum from the codes. The kernel's launch counter must equal the
   run's row chunks times its two strands.
5. The offset-sweep kernel (csrc/sweep.cu) against its plain version, bit
   for bit, on a seeded synthetic genome of R64 chromosome IV's length
   (1,531,933 bp + EOG) with planted forward and reverse-complement
   near-copies and N runs: 4,096-offset slices of a sense, an antisense and
   a reversed sweep at full length and the slice that ends at G - K; all
   four sweeps in full on 3 kbp. The first slice timed with CUDA events.
6. The sweep engine end to end: `hammings_exhaustive(legacy_sweep=True,
   use_kernel=True)` on that genome, both strands, equal at every position
   to the max-match engine, with exactly four sweep launches; and equal to
   the numpy oracles of phase 3 (K 7 and 25, antisense on and off).
7. The gather kernel (csrc/take.cu): the profiler
   `python -m kit4b_tpu_torch.tools.profile_gather` (524,288 indices into
   a 262,144-entry table), then the kernel against its plain version bit
   for bit on the same inputs with indices counted from the end and out of
   range.
8. kalign, the single-end path (plain PyTorch passes on the card; no
   kernel of its own yet). (a) The port on the seeded workload of
   `kit4b_tpu_torch.tools.make_kalign_golden` (200 kbp with a planted
   repeat, 8,192 reads with Ns, v5 forced, tier 2 overflowed) against the
   JAX package's committed golden: tier-1 rows, nar/pos/strand/mm, the
   tier-2 read count and the SAM's SHA-256, all equal. (b) Config #1 at
   full size: the genome and reads of bench.py (4.6 Mbp, 100,000 simreads
   reads of 100 bp, Illumina-skewed 2 % substitutions) written as FASTA,
   then the port's CLI `index` and `kalign -b 98304 -M 1`. Checks: the v5
   tier 1 ran, the native `pack2bit_u8` and `format_sam_se` were bound,
   >= 99.9 % of accepted reads sit at their QNAME truth locus and strand,
   every accepted read's `NM:i:` equals its mismatches recomputed from the
   genome, and the CLI's first batch (98,304 reads, the timed shapes) run
   again on the card and on the CPU gives the same tier-1 rows and classes
   on both, which the CLI's SAM records of those reads agree with. Prints the CLI phases, reads/s, the median of 5 CUDA-event
   timings of `fast_pass_packed_v5` on a device-resident 98,304-read
   batch, its tier-2 and ladder read counts, and peak device memory.

Each kernel's launch counter is set to 0 just before its path (phases 4,
6, 7) and read just after it; phase 8 runs none of the three kernels. The
line before the last is a JSON table of the kernels, each with its bound
(the least time the card could take: int8 tensor operations for minmm,
popcounts for sweep, bytes for take); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import logging
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

SEED = 20240611
K = 25
T, S, ROW_CHUNK = 2048, 1024, 1 << 21   # the engine's defaults
NUMNODES = 4           # node 1 of NUMNODES takes 1/NUMNODES of the partner spans
R64_LENGTHS = [        # S. cerevisiae S288C R64 nuclear chromosomes I-XVI
    230_218, 813_184, 316_620, 1_531_933, 576_874, 270_161, 1_090_940,
    562_643, 439_888, 745_751, 666_816, 1_078_177, 924_431, 784_333,
    1_091_291, 948_066]
N_RANDOM, N_PLANTED = 2000, 500
CHR4_LEN = R64_LENGTHS[3]   # chromosome IV, the sweep engine's genome
SWEEP_SLICE = 4096     # offsets of each phase-5 slice
ECOLI_LEN, ECOLI_READS = 4_600_000, 100_000   # config #1, as bench.py
ECOLI_BATCH, READ_LEN = 98_304, 100
INT8_PEAK = 1979e12    # H100 SXM dense int8 tensor operations per second
HBM_RATE = 3.35e12     # H100 SXM device memory bytes per second
# popcounts per second: 16 per clock per SM, 132 SMs, 1.98 GHz
POPC_RATE = 16 * 132 * 1.98e9
WIDE_K = (51, 153)     # Cw 256 and 768, the widths past the main path's 128
WIDE_GP = 262_144      # windows of the wide-row cases: a prefix of the genome
ROMAN = ["I", "II", "III", "IV", "V", "VI", "VII", "VIII", "IX", "X", "XI",
         "XII", "XIII", "XIV", "XV", "XVI"]


def _revcomp(codes: np.ndarray) -> np.ndarray:
    rev = codes[::-1]
    return np.where(rev < 4, 3 - rev, rev).astype(np.uint8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _time_ms(torch, fn) -> float:
    """Milliseconds of one call of fn, timed with CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def write_fasta(path: Path, names: list[str], chroms: list[np.ndarray],
                wrap: int = 60) -> None:
    """FASTA of base codes 0-4 (ACGTN), `wrap` bases per line."""
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for name, c in zip(names, chroms):
            s = acgtn[c].tobytes()
            f.write(b">" + name.encode() + b"\n")
            f.write(b"".join(s[i:i + wrap] + b"\n"
                             for i in range(0, len(s), wrap)))


def synthetic_r64(rng):
    """Seeded random chromosomes of R64's lengths with planted near-copies
    (forward copies of sources in the genome's first partner spans and
    reverse-complement copies of sources in its last ones, so node 1 sees
    them on both strands) and N runs. Returns (chroms, planted dest
    (chrom, start, length) list)."""
    chroms = [rng.integers(0, 4, n, dtype=np.uint8) for n in R64_LENGTHS]
    planted = []
    for i in range(12):
        L = 3000
        if i % 2 == 0:   # forward copy of a chrI segment
            s = int(rng.integers(1000, 150_000))
            seg = chroms[0][s:s + L].copy()
        else:            # reverse-complement copy of a chrXVI tail segment
            n16 = len(chroms[15])
            s = int(rng.integers(n16 - 150_000, n16 - L - 1000))
            seg = _revcomp(chroms[15][s:s + L])
        subs = rng.choice(L, 4, replace=False)
        seg[subs] = (seg[subs] + rng.integers(1, 4, 4)) % 4
        c = int(rng.integers(1, 15))
        d = int(rng.integers(0, len(chroms[c]) - L))
        chroms[c][d:d + L] = seg
        planted.append((c, d, L))
    for _ in range(6):
        c = int(rng.integers(0, 16))
        d = int(rng.integers(0, len(chroms[c]) - 400))
        chroms[c][d:d + int(rng.integers(50, 400))] = 4
    return chroms, planted


def synthetic_chr4(rng) -> np.ndarray:
    """Seeded random codes of R64 chromosome IV's length with six forward
    and six reverse-complement near-copies (3 kbp with 4 substitutions
    each) and six N runs, then EOG."""
    g = rng.integers(0, 4, CHR4_LEN, dtype=np.uint8)
    L = 3000
    for i in range(12):
        s = int(rng.integers(0, CHR4_LEN - L))
        seg = g[s:s + L].copy() if i % 2 == 0 else _revcomp(g[s:s + L])
        subs = rng.choice(L, 4, replace=False)
        seg[subs] = (seg[subs] + rng.integers(1, 4, 4)) % 4
        d = int(rng.integers(0, CHR4_LEN - L))
        g[d:d + L] = seg
    for _ in range(6):
        d = int(rng.integers(0, CHR4_LEN - 400))
        g[d:d + int(rng.integers(50, 400))] = 4
    return np.append(g, 0x0F).astype(np.uint8)


def direct_node_min(torch, dev, seq, pos, c_lo, c_hi, Gp):
    """Node partial minimum at concatenated positions `pos`, straight from
    the codes: min over the partner windows j in [c_lo, c_hi) of both
    strands (sense j != pos) of the Hamming distance, where a window that
    holds a sentinel (code >= 5) or starts past G - K counts as K, as the
    engine's zero rows do; 0xFFFF where the window at pos is not valid."""
    G = len(seq)
    nk = G - K + 1
    pad = np.full(Gp + K - G, 0x0F, np.uint8)
    fwd = torch.from_numpy(np.concatenate([seq, pad])).to(dev)
    rc = torch.from_numpy(np.concatenate([_revcomp(seq), pad])).to(dev)
    p = torch.from_numpy(pos).to(dev)
    q = fwd.unfold(0, K, 1)[p]
    qvalid = ~(q >= 5).any(1) & (p < nk)
    best = torch.full((len(pos),), K, dtype=torch.int32, device=dev)
    cols = torch.arange(c_lo, c_hi, device=dev)
    for src, sense in ((fwd, True), (rc, False)):
        pw = src.unfold(0, K, 1)[c_lo:c_hi]
        pvalid = ~(pw >= 5).any(1) & (cols < nk)
        for b in range(0, len(pos), 32):
            d = (q[b:b + 32, None, :] != pw[None]).sum(2, dtype=torch.int32)
            d = torch.where(pvalid[None], d, K)
            if sense:
                d = torch.where(p[b:b + 32, None] == cols[None], 1 << 20, d)
            best[b:b + 32] = torch.minimum(best[b:b + 32], d.amin(1))
    return torch.where(qvalid, best, 0xFFFF).cpu().numpy()


def sweep_vs_plain(torch, dev, seq, card):
    """Phase 5: the sweep kernel against its plain version, bit for bit, at
    full length on 4,096-offset slices and in full on 3 kbp; the first slice
    timed in turns. Returns (max_abs_err, kernel ms, plain ms, bound ms)."""
    from kit4b_tpu_torch.kernels.sweep import sweep, sweep_plain

    def codes(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def cases_of(g):   # the engine's four sweeps: (label, own, partner, d_lo)
        rc = _revcomp(g)
        return [("sense forward", codes(g), codes(g), 1),
                ("antisense forward", codes(g), codes(rc), 0),
                ("sense reversed", codes(g[::-1]), codes(g[::-1]), 1),
                ("antisense reversed", codes(g[::-1]), codes(rc[::-1]), 0)]

    G = len(seq)
    full = cases_of(seq)
    small = seq[:3000].copy()
    small[2000:2100] = small[100:200]          # a repeat
    small[1500], small[-1] = 7, 0x0F           # EOS, EOG
    runs = [(label, own, part, lo, lo + SWEEP_SLICE, G)
            for label, own, part, lo in full[:3]]
    runs.append(("sense forward, the slice that ends at G - K", full[0][1],
                 full[0][2], G - K - SWEEP_SLICE, None, G))
    runs += [(f"{label}, 3 kbp in full", own, part, lo, None, len(small))
             for label, own, part, lo in cases_of(small)]
    max_err = 0
    for label, own, part, lo, hi, gv in runs:
        kw = dict(K=K, G_valid=gv, d_lo=lo, d_hi=hi)
        got, want = sweep(own, part, **kw), sweep_plain(own, part, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        print(f"sweep vs plain [{label}]: G={gv} d in [{lo}, {hi}): "
              f"equal={torch.equal(got, want)} max_abs_err={err} "
              f"(min {int(want.min())}, {int((want < 9999).sum())} starts "
              f"with a valid pair)")
        if not torch.equal(got, want):
            raise AssertionError(f"sweep kernel differs from plain: {label}")
    # the comparison of runs[0] above warmed both functions at this shape
    _, own, part, lo, hi, gv = runs[0]
    kw = dict(K=K, G_valid=gv, d_lo=lo, d_hi=hi)
    turns = []
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = sweep_plain if name == "plain" else sweep
        turns.append((name, _time_ms(torch, lambda: fn(own, part, **kw))))
    k_ms = [ms for n, ms in turns if n == "kernel"]
    p_ms = [ms for n, ms in turns if n == "plain"]
    kernel_ms, plain_ms = sum(k_ms) / 2, sum(p_ms) / 2
    pairs = SWEEP_SLICE * (G - K + 1) - SWEEP_SLICE * (SWEEP_SLICE + 1) // 2
    out_bytes = got.numel() * got.element_size()
    bound = max(pairs / POPC_RATE,
                (own.numel() + part.numel() + out_bytes) / HBM_RATE) * 1e3
    print(f"sweep at G={G} K={K} d in [{lo}, {hi}) on {card}: kernel {k_ms} "
          f"ms, plain {p_ms} ms (turns plain, kernel, kernel, plain); "
          f"kernel {pairs / kernel_ms * 1e3} window pairs/s, plain "
          f"{pairs / plain_ms * 1e3} pairs/s; bound {bound} ms (one popcount "
          f"a pair at {POPC_RATE:g}/s), kernel at {bound / kernel_ms} of it")
    return max_err, kernel_ms, plain_ms, bound


def sweep_engine(torch, dev, seq, oracle_genome, oracles, card):
    """Phase 6: the sweep engine end to end on the chrIV-length genome,
    against the max-match engine and the numpy oracles. Returns the sweep
    kernel's launches in the engine run."""
    from kit4b_tpu_torch.kernels.sweep import sweep
    from kit4b_tpu_torch.kmer.hammings import hammings_exhaustive
    from kit4b_tpu_torch.kmer.hammings_mxu import hammings_exhaustive_mxu
    G = len(seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = hammings_exhaustive(seq, K, legacy_sweep=True, use_kernel=True,
                              device=dev)     # returns numpy: synchronised
    wall = time.perf_counter() - t0
    launches = sweep.launches
    peak = torch.cuda.max_memory_allocated()
    nk = G - K + 1
    print(f"sweep engine on {G} bp (K={K}, both strands) on {card}: wall "
          f"{wall} s, {2 * nk * nk / wall} window pairs/s (2 N^2 / s), "
          f"{nk / wall} k-mer rows/s, peak device memory {peak} bytes, "
          f"sweep launches {launches}")
    if launches != 4:
        raise AssertionError(f"the sweep engine launched the kernel "
                             f"{launches} times, not 4")
    t0 = time.perf_counter()
    want = hammings_exhaustive_mxu(seq, K, device=dev)
    mxu_wall = time.perf_counter() - t0
    bad = np.nonzero(got != want)[0]
    print(f"sweep engine vs max-match engine ({mxu_wall} s): {len(bad)} of "
          f"{G} positions differ; min {int(got.min())}, zeros "
          f"{int((got == 0).sum())}, no valid window "
          f"{int((got == 0xFFFF).sum())}")
    if len(bad):
        raise AssertionError(f"sweep engine differs from the max-match "
                             f"engine at {bad[:5]}: {got[bad[:5]]} vs "
                             f"{want[bad[:5]]}")
    if int(got.min()) != 0:
        raise AssertionError("no planted copy reads distance 0")
    for (k, anti), want in oracles.items():
        before = sweep.launches
        got = hammings_exhaustive(oracle_genome, k, antisense=anti,
                                  legacy_sweep=True, use_kernel=True,
                                  device=dev)
        n = sweep.launches - before
        ok = np.array_equal(got, want)
        print(f"sweep engine vs oracle G={len(oracle_genome)} K={k} "
              f"antisense={anti}: equal={ok}, {n} launches")
        if not ok or n != (4 if anti else 2):
            raise AssertionError(f"sweep engine vs oracle: K={k} "
                                 f"antisense={anti} equal={ok} launches={n}")
    return launches


def gather(torch, dev):
    """Phase 7: the gather profiler, then the kernel against its plain
    version with indices counted from the end and out of range. Returns
    (launches in the profiler run, max_abs_err, kernel ms, plain ms, bound
    ms: the table, the indices and the output moved once)."""
    from kit4b_tpu_torch.kernels.take import FILL, take, take_plain
    from kit4b_tpu_torch.tools import profile_gather
    reset_launches()
    times = profile_gather.main()
    launches = take.launches
    if launches != profile_gather.CALLS + 1:
        raise AssertionError(f"the profiler launched the gather kernel "
                             f"{launches} times, not "
                             f"{profile_gather.CALLS + 1}")
    table, idx = profile_gather.inputs(dev)
    n = table.shape[0]
    idx[:5] = torch.tensor([-1, -n, -n - 1, n, n + 5], dtype=torch.int32)
    got, want = take(table, idx), take_plain(table, idx)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    edges = got[:5].tolist()
    print(f"take vs plain with indices -1, -T, -T-1, T, T+5: "
          f"equal={torch.equal(got, want)} max_abs_err={err}; "
          f"they read {edges}")
    if not torch.equal(got, want) or edges != [
            int(table[-1]), int(table[0]), FILL, FILL, FILL]:
        raise AssertionError("gather kernel differs from plain")
    bound = sum(t.numel() * t.element_size()
                for t in (table, idx, got)) / HBM_RATE * 1e3
    return launches, err, times["ms"], times["plain_ms"], bound


def kalign_escalations(torch, al, reads):
    """Tier-1 escalations of one batch on the aligner's v5 pass: (reads of
    class -3 after tier 1, which tier 2 takes up to E; reads still -3
    after tier 2, which go to the host ladder; the pass on the
    device-resident batch as a closure)."""
    from kit4b_tpu_torch.align.kalign import TIER2, pack_reads_2bit
    from kit4b_tpu_torch.ops import seed_extend_v5
    L = reads.shape[1]
    gview, sa, _, lut2 = al._device_for(L)
    lut4 = al._lut4_for(L, sa)
    _, mtm = al.schedule_for(L)
    r2b, nlist = pack_reads_2bit(reads)
    r2b = torch.from_numpy(r2b).to(al.device)
    nlist = torch.from_numpy(nlist).to(al.device)
    kw = dict(genome_len=len(al.index.genome.seq), read_len=L,
              offsets=al._offsets_for(L, mtm), lut_k=al.index.lut_k,
              n_compact=al.n_compact, n_extend=al.n_extend,
              max_tot_mm=mtm, mm_delta=al.mm_delta)

    def run(tier2=TIER2):
        return seed_extend_v5.fast_pass_packed_v5(
            gview, sa, lut2, lut4, r2b, nlist, tier2=tier2, **kw)
    return (int((run(None)[:, 0] == -3).sum()),
            int((run()[:, 0] == -3).sum()), run)


def kalign_golden(torch, dev):
    """Phase 8a: the port against the JAX package's golden."""
    from kit4b_tpu_torch.align import kalign
    from kit4b_tpu_torch.tools import make_kalign_golden as mg
    gold = np.load(mg.GOLDEN)
    g, idx, recs = mg.workload()
    if mg.inputs_sha256(g, recs) != str(gold["inputs_sha256"]):
        raise AssertionError("the golden workload rebuilt here differs from "
                             "the one the golden was made from")
    out = mg.compute(kalign, idx, recs, device=dev)
    reads = np.stack([r.codes for r in recs])
    out["n_tier2_reads"], _, _ = kalign_escalations(
        torch, kalign.KAligner(idx, batch_size=len(recs), use_v5=True,
                               device=dev), reads)
    bad = [k for k in gold.files
           if k != "inputs_sha256" and not np.array_equal(out[k], gold[k])]
    print(f"kalign golden ({len(recs)} reads, {len(g.seq)} bp, v5 forced): "
          f"tier-2 reads {int(out['n_tier2_reads'])}, ladder reads "
          f"{int(out['n_ladder_reads'])}, accepted "
          f"{int((out['nar'] == 0).sum())}; differs from the JAX golden "
          f"in {bad or 'nothing'}")
    if bad:
        raise AssertionError(f"kalign differs from the JAX golden in {bad}")


def _sam_body(path: Path):
    """(qname, flag, rname, pos, seq, NM) columns of a SAM's records."""
    qn, flag, rname, pos, seq, nm = [], [], [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.rstrip("\n").split("\t")
            qn.append(c[0])
            flag.append(int(c[1]))
            rname.append(c[2])
            pos.append(int(c[3]))
            seq.append(c[9])
            nm.append(int(c[11][5:]) if len(c) > 11 else -1)
    return qn, np.array(flag), rname, np.array(pos), seq, np.array(nm)


def kalign_full(torch, dev, card, tmp: Path):
    """Phase 8b: config #1 at full size through the port's CLI."""
    from kit4b_tpu_torch import cli, dna, native
    from kit4b_tpu_torch.align import kalign
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import Genome
    from kit4b_tpu_torch.sim import simreads
    lib = native.load()
    print(f"native host library {native.lib_path()}: pack2bit_u8 "
          f"{lib.pack2bit_u8.argtypes is not None}, format_sam_se "
          f"{lib.format_sam_se.argtypes is not None}")
    rng = np.random.default_rng(12345)
    codes = rng.integers(0, 4, ECOLI_LEN).astype(np.uint8)
    g = Genome(["ecoli_sim"], np.array([0]), np.array([ECOLI_LEN]),
               np.append(codes, dna.BASE_EOG).astype(np.uint8))
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=ECOLI_READS, read_len=READ_LEN, seed=7,
        error_mode="illumina", subs_rate=0.02))
    fa, reads_fa = tmp / "ecoli_sim.fa", tmp / "reads.fa"
    kix, sam = tmp / "ecoli_sim.kix", tmp / "out.sam"
    write_fasta(fa, ["ecoli_sim"], [codes])
    simreads.write_reads(reads_fa, recs)

    phases = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(phases)
    t0 = time.perf_counter()
    rc = cli.main(["index", "-i", str(fa), "-o", str(kix)])
    t_index = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI index exited {rc}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["kalign", "-i", str(reads_fa), "-I", str(kix), "-o",
                   str(sam), "-b", str(ECOLI_BATCH), "-M", "1"])
    t_kalign = time.perf_counter() - t0
    peak_cli = torch.cuda.max_memory_allocated()
    logging.getLogger("kit4b_tpu_torch").removeHandler(phases)
    if rc != 0:
        raise AssertionError(f"CLI kalign exited {rc}")
    print(f"CLI on {card}: index {t_index} s, kalign {t_kalign} s "
          f"({ECOLI_READS / t_kalign} reads/s; align phase "
          f"{ECOLI_READS / phases.seconds['align']} reads/s), phases "
          f"{phases.seconds}; peak device memory {peak_cli} bytes; tier 1 "
          f"{phases.tier1}; classes {phases.stats}")
    if phases.tier1 != {READ_LEN: "v5"}:
        raise AssertionError(f"kalign took tier 1 {phases.tier1}, not v5")

    idx = SfxIndex.load(kix)
    if not np.array_equal(idx.genome.seq, g.seq):
        raise AssertionError("the index holds another genome")
    qn, flag, rname, pos, seq, nm = _sam_body(sam)
    acc = np.nonzero((flag & 4) == 0)[0]
    if len(qn) != ECOLI_READS or len(acc) < 0.9 * ECOLI_READS:
        raise AssertionError(f"SAM holds {len(qn)} records, {len(acc)} "
                             "accepted")
    n_true = 0
    for i in acc:
        t = simreads.parse_truth(qn[i])
        n_true += (rname[i] == t["chrom"] and pos[i] - 1 == t["start"]
                   and ("-" if flag[i] & 16 else "+") == t["strand"])
    rcodes = dna.encode("".join(seq[i] for i in acc)).reshape(-1, READ_LEN)
    gwin = idx.genome.seq[(pos[acc] - 1)[:, None] + np.arange(READ_LEN)]
    nm_genome = ((rcodes != gwin) | (rcodes >= 4) | (gwin >= 4)).sum(1)
    nm_bad = int((nm_genome != nm[acc]).sum())
    print(f"SAM check: {len(qn)} records, {len(acc)} accepted "
          f"({len(acc) / len(qn)}), {n_true / len(acc)} of them at their "
          f"truth locus and strand; NM differs from the genome's "
          f"mismatches in {nm_bad}")
    if n_true < 0.999 * len(acc) or nm_bad:
        raise AssertionError(f"{n_true} of {len(acc)} accepted reads at "
                             f"their truth locus; {nm_bad} NM mismatches")

    # the CLI's first batch again, at its shapes, on the card and the CPU
    batch = np.stack([r.codes for r in recs[:ECOLI_BATCH]])
    got = []
    for d in (dev, torch.device("cpu")):
        al = kalign.KAligner(idx, batch_size=ECOLI_BATCH, device=d)
        t0 = time.perf_counter()
        out = al._submit(batch)
        rows = out[1].cpu().numpy()
        raw = al._collect_compact(out, batch)
        got.append((time.perf_counter() - t0, [rows] + [
            raw[k] for k in ("nar", "pos", "strand", "mm")]))
    same = all(np.array_equal(a, b) for a, b in zip(got[0][1], got[1][1]))
    _, nar, bpos, bstrand, bmm = got[1][1]
    acc_b = nar == 0
    b = slice(0, ECOLI_BATCH)
    sam_same = (np.array_equal((flag[b] & 4) == 0, acc_b)
                and np.array_equal(pos[b][acc_b] - 1, bpos[acc_b])
                and np.array_equal((flag[b][acc_b] & 16) != 0,
                                   bstrand[acc_b] == 1)
                and np.array_equal(nm[b][acc_b], bmm[acc_b]))
    print(f"the CLI's first batch ({ECOLI_BATCH} reads) again on the card "
          f"({got[0][0]} s) and on the CPU ({got[1][0]} s): rows and "
          f"classes equal: {same}; the CLI's SAM records of that batch "
          f"agree with them: {sam_same}")
    if not (same and sam_same):
        raise AssertionError("the CPU, the card and the CLI's SAM differ on "
                             "the first batch")

    al = kalign.KAligner(idx, batch_size=ECOLI_BATCH, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_t2, n_ladder, run = kalign_escalations(torch, al, batch)  # warms up
    ms = sorted(_time_ms(torch, run) for _ in range(5))
    peak_pass = torch.cuda.max_memory_allocated()
    print(f"fast_pass_packed_v5 on {ECOLI_BATCH} device-resident reads on "
          f"{card}: median {ms[2]} ms of 5 (CUDA events: {ms}), "
          f"{ECOLI_BATCH / ms[2] * 1e3} reads/s; tier-2 reads {n_t2}, "
          f"ladder reads {n_ladder}; peak device memory {peak_pass} bytes "
          f"(tables and pass)")
    if not al._lut4_decided[READ_LEN]:
        raise AssertionError("the timed aligner did not take v5")


def minmm_cases(torch, cases, minmm, minmm_plain) -> int:
    """Phase 2: the min-match kernel against its plain version, bit for
    bit, on (label, own rows, partner, diag, span_lo, span_cnt, row_base)
    cases. Returns the largest absolute difference (0)."""
    max_err = 0
    for label, wo, wp, diag, lo, n, rb in cases:
        kw = dict(diag=diag, span_lo=lo, span_cnt=n, S=S, row_base=rb)
        got = minmm(wo, wp, **kw)
        want = minmm_plain(wo, wp, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        print(f"kernel vs plain [{label}]: R={wo.shape[0]} Cw={wo.shape[1]} "
              f"span_lo={lo} span_cnt={n} row_base={rb}: "
              f"equal={torch.equal(got, want)} max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"kernel differs from plain: {label}")
    return max_err


def reset_launches() -> None:
    """Sets every kernel's launch counter to 0."""
    from kit4b_tpu_torch.kernels.minmm import minmm
    from kit4b_tpu_torch.kernels.sweep import sweep
    from kit4b_tpu_torch.kernels.take import take
    minmm.launches = sweep.launches = take.launches = 0


class _PhaseLog(logging.Handler):
    """Keeps the unrounded seconds of the CLI's PhaseTimer phases, and
    kalign's class counts and tier-1 pass by read length."""

    def __init__(self):
        super().__init__()
        self.seconds = {}
        self.stats = self.tier1 = None

    def emit(self, record):
        if record.msg == "phase %s: %.2fs":
            self.seconds[record.args[0]] = record.args[1]
        elif str(record.msg).startswith("kalign: %d reads"):
            self.stats, self.tier1 = record.args[1], record.args[2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs an NVIDIA "
              "card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "kit4b_tpu_torch").is_dir():
        print(f"chip_smoke: {root} holds no kit4b_tpu_torch package; run "
              "it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.kernels import build
    from kit4b_tpu_torch.kernels.minmm import minmm, minmm_plain
    from kit4b_tpu_torch.kmer.hammings import hammings_oracle, read_hmg
    from kit4b_tpu_torch.kmer.hammings_mxu import (build_w,
                                                   hammings_exhaustive_mxu)
    from kit4b_tpu_torch.tools.time_minmm import COLS, ROWS, time_widths
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # --- 1. card, toolkit, kernel build -------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    kernels = ("minmm", "sweep", "take")
    built = [k for k in kernels if build.paths(k)[1].exists()]
    t0 = time.perf_counter()
    build.build(*kernels)
    print(f"kernel build (nvcc, sm_90a, {len(kernels)} at once): "
          f"{time.perf_counter() - t0} s"
          + (f" ({built} already built)" if built else ""))
    for k in kernels:
        for line in build.paths(k)[2].read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "warning")):
                print(f"  ptxas {k}:", line.strip())
    spills = [line.strip() for line in
              build.paths("minmm")[2].read_text().splitlines()
              if re.search(r"[1-9][0-9]* bytes spill (stores|loads)", line)]
    if spills:
        raise AssertionError(f"minmm spills: {spills}")

    # --- the phase-4 genome and its node geometry ---------------------
    chroms, planted = synthetic_r64(rng)
    G = sum(len(c) + 1 for c in chroms)        # one EOS/EOG after each
    Gp = _round_up(max(G, max(T, S)), max(T, S))
    n_spans = Gp // S
    cnt = n_spans // NUMNODES                  # node 1: spans [0, cnt)
    seq = np.concatenate([np.append(c, 7) for c in chroms]).astype(np.uint8)
    seq[-1] = 0x0F

    # --- 2. kernel vs plain at the main path's shapes -----------------
    ext = torch.from_numpy(np.concatenate(
        [seq, np.full(Gp + K - G, 0x0F, np.uint8)])).to(dev)
    W, _ = build_w(ext, K=K, Gp=Gp, G=G, rc=False)
    Wrc, _ = build_w(ext, K=K, Gp=Gp, G=G, rc=True)
    R = min(_round_up(Gp, T), _round_up(ROW_CHUNK, T))   # the engine's chunk
    short = 184    # spans of the coverage cases: 1/64 of the genome
    cases = [   # (label, own rows, partner, diag, span_lo, span_cnt, row_base)
        ("main path: sense, rows [0,R), node 1 spans", W[:R], W, True, 0,
         cnt, 0),
        ("sense, rows [R,2R), diag inside span_lo=R/S", W[R:2 * R], W, True,
         R // S, short, R),
        ("antisense, rows [R,2R), span_lo>0", W[R:2 * R], Wrc, False,
         cnt, short, R),
        ("sense, tail rows [Gp-R,Gp), span_lo>0", W[Gp - R:], W, True,
         2 * cnt, short, Gp - R),
        ("sense, 384 rows [1024,1408), diag inside", W[1024:1408], W, True,
         0, 8, 1024),
    ]
    max_err = minmm_cases(torch, cases, minmm, minmm_plain)
    # the comparison of cases[0] above warmed both functions at this shape
    _, wo, wp, diag, lo, n, rb = cases[0]
    kw = dict(diag=diag, span_lo=lo, span_cnt=n, S=S, row_base=rb)
    turns = []
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = minmm_plain if name == "plain" else minmm
        turns.append((name, _time_ms(torch, lambda: fn(wo, wp, **kw))))
    k_ms = [ms for n, ms in turns if n == "kernel"]
    p_ms = [ms for n, ms in turns if n == "plain"]
    kernel_ms, plain_ms = sum(k_ms) / 2, sum(p_ms) / 2
    cw = W.shape[1]
    ops = 2 * R * cnt * S * cw
    minmm_bound = max(ops / INT8_PEAK,
                      (R * cw + cnt * S * cw + 4 * R) / HBM_RATE) * 1e3
    print(f"min-match at R={R} span={cnt * S} Cw={cw} on {card}: "
          f"kernel {k_ms} ms, plain {p_ms} ms (turns plain, kernel, "
          f"kernel, plain); kernel {ops / kernel_ms / 1e9} int8 TOP/s, "
          f"plain {ops / plain_ms / 1e9} TOP/s; bound {minmm_bound} ms "
          f"(int8 operations at {INT8_PEAK / 1e12:g} TOP/s), kernel at "
          f"{minmm_bound / kernel_ms} of it")
    del W, Wrc, wo, wp, cases
    torch.cuda.empty_cache()
    # wide rows on a prefix of the genome: Cw 256 and 768, R = 384 included
    gw = WIDE_GP - 1000
    for k in WIDE_K:
        e = ext[:WIDE_GP + k].clone()
        e[gw:] = 0x0F
        Wk, _ = build_w(e, K=k, Gp=WIDE_GP, G=gw, rc=False)
        Wkrc, _ = build_w(e, K=k, Gp=WIDE_GP, G=gw, rc=True)
        max_err = max(max_err, minmm_cases(torch, [
            (f"K={k} sense, rows [4096,6144), diag inside", Wk[4096:6144],
             Wk, True, 0, 64, 4096),
            (f"K={k} antisense, 384 rows, span_lo>0", Wk[:384], Wkrc, False,
             5, 40, 0),
            (f"K={k} sense, 384 rows [384,768), diag inside", Wk[384:768],
             Wk, True, 0, 8, 384),
        ], minmm, minmm_plain))
        del Wk, Wkrc, e
    del ext
    torch.cuda.empty_cache()
    # every width timed on a card-filling shape, beside its int8 bound
    for row in time_widths(torch, minmm):
        print(f"min-match width timing on {card}: Cw={row['Cw']} "
              f"R={ROWS} span={COLS}: kernel {row['ms']} ms; bound "
              f"{row['bound_ms']} ms ({row['bound_by']}), kernel at "
              f"{row['bound_ms'] / (sum(row['ms']) / 2)} of it")
    torch.cuda.empty_cache()

    # --- 3. the engine on the card vs the numpy oracle ----------------
    g = rng.integers(0, 4, 2000).astype(np.uint8)
    g[700] = 7                                  # EOS
    g[rng.integers(0, 2000, 12)] = 4            # N bases
    g[1500:1560] = g[200:260]                   # a repeat: distance 0
    g[1530] = (g[1530] + 1) % 4                 # and 1
    combos = [(k, anti) for k in (7, 25) for anti in (True, False)]
    oracle_results = {}     # phase 6 holds the sweep engine to them too
    with ProcessPoolExecutor(len(combos), mp_context=get_context("spawn")) \
            as pool:
        oracles = [pool.submit(hammings_oracle, g, k, anti)
                   for k, anti in combos]
        for (k, anti), fut in zip(combos, oracles):
            got = hammings_exhaustive_mxu(g, k, antisense=anti, device=dev)
            want = oracle_results[k, anti] = fut.result()
            ok = np.array_equal(got, want)
            print(f"oracle check G=2000 K={k} antisense={anti}: equal={ok} "
                  f"(min {int(want[:2000 - k + 1].min())})")
            if not ok:
                raise AssertionError(f"engine differs from oracle: K={k} "
                                     f"antisense={anti}")

    # --- 4. the CLI end to end on the R64-sized genome ----------------
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        fa, out = Path(tmp) / "r64_synthetic.fa", Path(tmp) / "node1.hmg"
        write_fasta(fa, [f"chr{r}" for r in ROMAN], chroms)
        print(f"CLI: hammings -K {K} -n {NUMNODES} -N 1 on {G - 16} bp in "
              f"16 chromosomes (node 1 of {NUMNODES}: partner spans "
              f"[0, {cnt}) of {n_spans}, {cnt * S} columns per strand)")
        phases = _PhaseLog()
        logging.getLogger("kit4b_tpu_torch").addHandler(phases)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["hammings", "-i", str(fa), "-o", str(out), "-K",
                       str(K), "-n", str(NUMNODES), "-N", "1"])
        wall = time.perf_counter() - t0
        launches = minmm.launches
        peak = torch.cuda.max_memory_allocated()
        logging.getLogger("kit4b_tpu_torch").removeHandler(phases)
        if rc != 0:
            raise AssertionError(f"CLI exited {rc}")
        sweep = phases.seconds["sweep"]
        nk = G - K + 1
        print(f"CLI on {card}: wall {wall} s, phases {phases.seconds}; "
              f"{nk / sweep} k-mer rows/s for the node's share "
              f"({2 * nk * cnt * S / sweep} window pairs/s over both "
              f"strands); peak device memory {peak} bytes; "
              f"kernel launches {launches}")
        want_launches = -(-Gp // R) * 2    # row chunks x both strands
        if launches != want_launches:
            raise AssertionError(f"the CLI run launched the min-match kernel "
                                 f"{launches} times, not {want_launches}")
        names, dists = read_hmg(out)

    if names != [f"chr{r}" for r in ROMAN]:
        raise AssertionError(f"chromosome names read back: {names}")
    starts = np.cumsum([0] + [len(c) + 1 for c in chroms[:-1]])
    sel = []   # (chrom, offset)
    for _ in range(N_RANDOM):
        c = int(rng.choice(16, p=np.array(R64_LENGTHS) / sum(R64_LENGTHS)))
        sel.append((c, int(rng.integers(0, R64_LENGTHS[c] - K + 1))))
    for i in range(N_PLANTED):
        c, d, L = planted[i % len(planted)]
        sel.append((c, d + int(rng.integers(0, L - K + 1))))
    got = np.array([dists[c][o] for c, o in sel], np.uint16)
    pos = np.array([starts[c] + o for c, o in sel], np.int64)
    want = direct_node_min(torch, dev, seq, pos, 0, cnt * S, Gp)
    bad = np.nonzero(got != want)[0]
    print(f"sample check: {len(sel)} positions ({N_RANDOM} random, "
          f"{N_PLANTED} planted), {len(bad)} differ; sampled minima "
          f"min {int(got.min())} median {float(np.median(got))} "
          f"zeros {int((got == 0).sum())}; "
          f"whole-node zeros {sum(int((d == 0).sum()) for d in dists)}")
    if len(bad):
        raise AssertionError(f"node result differs from the direct "
                             f"computation at {pos[bad[:5]]}: "
                             f"{got[bad[:5]]} vs {want[bad[:5]]}")
    if int(got[N_RANDOM:].min()) != 0:
        raise AssertionError("no planted position reads distance 0")

    # --- 5-7. the sweep kernel, the sweep engine, the gather ----------
    chr4 = synthetic_chr4(np.random.default_rng(SEED + 4))
    sweep_err, sweep_ms, sweep_plain_ms, sweep_bound = sweep_vs_plain(
        torch, dev, chr4, card)
    sweep_launches = sweep_engine(torch, dev, chr4, g, oracle_results, card)
    take_launches, take_err, take_ms, take_plain_ms, take_bound = gather(
        torch, dev)

    # --- 8. kalign: the JAX golden, then config #1 at full size -------
    kalign_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        kalign_full(torch, dev, card, Path(tmp))
    if "jax" in sys.modules or "kit4b_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package kit4b_tpu was imported")

    print(json.dumps({"kernels": [
        {"name": "minmm", "route": "cuda",
         "source": "kit4b_tpu_torch/csrc/minmm.cu",
         "replaces": "kit4b_tpu/kmer/hammings_mxu.py:100",
         "launches": launches, "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": minmm_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "sweep", "route": "cuda",
         "source": "kit4b_tpu_torch/csrc/sweep.cu",
         "replaces": "kit4b_tpu/kmer/hammings_kernel.py:55",
         "launches": sweep_launches, "max_abs_err": sweep_err,
         "ms": sweep_ms, "plain_ms": sweep_plain_ms, "bound_ms": sweep_bound,
         "bound_by": "operations", "library_ms": None},
        {"name": "take", "route": "cuda",
         "source": "kit4b_tpu_torch/csrc/take.cu",
         "replaces": "tools/archive/profile_pallas_gather.py:36",
         "launches": take_launches, "max_abs_err": take_err,
         "ms": take_ms, "plain_ms": take_plain_ms, "bound_ms": take_bound,
         "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
