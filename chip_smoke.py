#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kit4b_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package kit4b_tpu. Each phase
raises on failure, and the script then exits non-zero without printing a
result:

1. The card's name and power limit (nvidia-smi), the CUDA version, and the
   build of the three kernels (csrc/minmm.cu, sweep.cu, take.cu; one nvcc
   each, all at once) with ptxas's report; none may spill, and sweep and
   take may not keep a stack frame.
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
   a reversed sweep at full length and the slice that ends at G - K; sense
   and antisense slices at K 7 and 13; all four sweeps in full on 3 kbp,
   and the sense and antisense sweeps on 3 kbp at every K 1..25; 3 kbp cut
   into contigs of 20-40 bp (K 7, 13) and of 10-30 bp (K 25), and 64 bp
   whose few valid own and partner starts sit at different bits of a word
   (what the kernel's skip of 32 offsets must keep). The first
   slice timed with CUDA events in turns with the plain version, beside
   its bound (int8 tensor operations, the card's fastest way to count
   matches over window pairs) and the floors of the one-popcount-a-pair and
   the bit-sliced methods; then the K 7, 13 and 25 slices of both strands
   timed by `kit4b_tpu_torch.tools.time_sweep`.
6. The sweep engine end to end: `hammings_exhaustive(legacy_sweep=True,
   use_kernel=True)` on that genome, both strands, equal at every position
   to the max-match engine, with exactly four sweep launches; and equal to
   the numpy oracles of phase 3 (K 7 and 25, antisense on and off).
7. The gather kernel (csrc/take.cu): the profiler
   `python -m kit4b_tpu_torch.tools.profile_gather` (524,288 indices into
   a 262,144-entry table; CUDA events over host launches), then the
   kernel's and the plain version's device time per call (`torch.profiler`
   over 200 calls, and the replay of a CUDA graph of 200 calls) and the
   kernel's device time over a range of sizes, then the kernel against its
   plain version bit for bit on the same inputs with indices counted from
   the end and out of range, on 524,291 and 9 indices (ragged tails) and
   on views that start 4, 8 and 12 bytes past a 16-byte boundary.
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
9. kmarkers (plain PyTorch pass on the card). (a) The port on the seeded
   workload of `kit4b_tpu_torch.tools.make_kmarkers_golden` (three 36 kbp
   cultivars with planted repeat families, duplicates, N runs and
   neighbours) against the JAX package's committed golden: tier-1 pass
   codes batch by batch, marker lists with and without extension and the
   positions run in each tier, at min_hamming 1, 2 and 3, all equal.
   (b) The planted 3 x 6 kbp set of tests/test_golden_kmarkers.py: the
   accepted set equals the brute force of the documented contract.
   (c) BASELINE config #3 at full size: the cultivars of
   tools/config3_wheat.py (seed 33, 3 x 10 Mbp, 0.2 % SNPs, a private
   50 kbp block each) written as FASTA, then the port's CLI `kmarkers -t
   cult0 -K 50 -e 2 -m 1`. Checks: >= 99 % of the windows of cult0's
   private block accepted; 128 accepted and 128 rejected positions agree
   with a direct on-card minimum Hamming distance to every window of cult1
   and cult2, both strands, and with the in-target duplicate rule; the
   first two 49,152-position batches give the same codes on the card and
   the CPU. Prints the CLI phases, K-mers/s, the median of 5 CUDA-event
   timings of one pass on 49,152 resident positions, the positions of each
   tier, peak device memory and the device's busy share of the markers
   run by `torch.profiler`.
10. Restricted hammings (`hammings -r`, plain PyTorch on the card). (a)
   The golden's restricted outputs (the three genomes of
   tests/test_hammings.py and one with N runs at the default lut_k), equal.
   (b) On phase 6's chrIV-length genome against phase 6's max-match
   minimum at every window of A/C/G/T only: `-r 1` equals min(true, 2);
   `-r 3` equals the true minimum where it is at most W - 1 = 1 and lies in
   [min(true, 4), 4] elsewhere. (c) The CLI `hammings -r 3 -K 25` on phase
   4's 12.07 Mbp genome, 500 sampled A/C/G/T windows held to a direct
   on-card minimum over every window by the same rule. Prints the phases,
   K-mer rows/s and peak device memory.
11. Paired-end kalign (plain PyTorch passes on the card). (a) The port on
   the seeded workload of `kit4b_tpu_torch.tools.make_kalign_pe_golden`
   (two chromosomes of 200 kbp in all with repeat families, a tandem array,
   a duplicated block, a reverse-complemented copy and N runs; 2 x 100 and
   2 x 150 pairs, -b 1024, pe modes 1 and 2) against the JAX package's
   committed golden: tier-1 rows with and without tier 2, the pair rows
   each escalation stage took, the PePair stream and the SAM and VCF
   SHA-256, all equal. (b) BASELINE config #4 at full size through the
   CLI: `make_chr21_like(40.0)` (seed 21) as FASTA, `index`, `simreads -p
   -n 65536 -l 150 -j 250 -J 600 -e illumina -z 0.01 -N 1000 -S 9 -u` (SNPs
   planted by the CLI at 0.001 with seed 9), `kalign -u -U 1 -d 200 -D 700
   -b 16384 -S out.vcf`. Checks: >= 80 % of pairs accepted and >= 98 % of
   their mates at the QNAME truth locus; the first two batches' PePair
   streams equal on the card and the CPU; pinned and pageable uploads give
   the same stream. Prints the CLI phases, reads/s, SNP sensitivity and
   precision against the planted BED, pair rows by tier and stage, peak
   device memory, the align run's wall with pageable and pinned uploads
   (in turns: pageable, pinned, pinned, pageable),
   its device busy share and device operations by `torch.profiler`, that a
   warm pass with its uploads calls nothing that waits for the device
   (`torch.cuda.set_sync_debug_mode("error")`), and the ms of one
   `pe_pass_packed` on 16,384 resident pairs, one `deep_pe_pass_planes` at
   E 4,096 and one `window_scan_pe` at R 16,384 (CUDA events, median of 5).

Each kernel's launch counter is set to 0 just before its path (phases 4,
6, 7) and read just after it; phases 8-11 run none of the three kernels.
The script prints its seconds before the kernels line. The
line before the last is a JSON table of the kernels, each with its bound
(the least time the card could take: int8 tensor operations for minmm
and sweep, bytes for take; take's `ms` is device time); the last line is
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
CONFIG3_LEN = 10_000_000   # bases of each config #3 cultivar
KM_BATCH = 49_152          # the kmarkers CLI's tier-1 batch
CONFIG4_MBP = 40.0         # config #4's chr21-like genome, Mbp
PE_PAIRS, PE_LEN, PE_BATCH = 65_536, 150, 16_384   # its 2 x 150 pairs
INT8_PEAK = 1979e12    # H100 SXM dense int8 tensor operations per second
HBM_RATE = 3.35e12     # H100 SXM device memory bytes per second
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


def direct_node_min(torch, dev, seq, pos, c_lo, c_hi, Gp, batch=32):
    """Node partial minimum at concatenated positions `pos`, straight from
    the codes: min over the partner windows j in [c_lo, c_hi) of both
    strands (sense j != pos) of the Hamming distance, where a window that
    holds a sentinel (code >= 5) or starts past G - K counts as K, as the
    engine's zero rows do; 0xFFFF where the window at pos is not valid.
    `batch` positions at a time: each holds an int32 [batch, c_hi - c_lo,
    K] on the card."""
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
        for b in range(0, len(pos), batch):
            d = (q[b:b + batch, None, :] != pw[None]).sum(
                2, dtype=torch.int32)
            d = torch.where(pvalid[None], d, K)
            if sense:
                d = torch.where(p[b:b + batch, None] == cols[None], 1 << 20,
                                d)
            best[b:b + batch] = torch.minimum(best[b:b + batch], d.amin(1))
    return torch.where(qvalid, best, 0xFFFF).cpu().numpy()


def sweep_vs_plain(torch, dev, seq, card):
    """Phase 5: the sweep kernel against its plain version, bit for bit, at
    full length on 4,096-offset slices (K 25, 7 and 13) and in full on 3 kbp
    (every K 1..25); the first slice timed in turns, then the K 7, 13 and
    25 slices of both strands. Returns (max_abs_err, kernel ms, plain ms,
    bound ms)."""
    from kit4b_tpu_torch.kernels.sweep import sweep, sweep_plain
    from kit4b_tpu_torch.tools import time_sweep

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
    runs = [(label, own, part, lo, lo + SWEEP_SLICE, G, K)
            for label, own, part, lo in full[:3]]
    runs.append(("sense forward, the slice that ends at G - K", full[0][1],
                 full[0][2], G - K - SWEEP_SLICE, None, G, K))
    runs += [(f"{label}, K={k}", own, part, lo, lo + SWEEP_SLICE, G, k)
             for k in (7, 13) for label, own, part, lo in full[:2]]
    runs += [(f"{label}, 3 kbp in full", own, part, lo, None, len(small), K)
             for label, own, part, lo in cases_of(small)]
    runs += [(f"{label}, 3 kbp in full, K={k}", own, part, lo, None,
              len(small), k)
             for k in range(1, 26) for label, own, part, lo
             in cases_of(small)[:2]]
    # few valid windows, at bit positions that do not line up: contigs cut
    # by an EOS every 20-40 bp (own and partner cut apart), contigs under K
    # with a few over, and 64 bp with own starts 0-3 and partner starts 10-14
    rng = np.random.default_rng(5)

    def contigs(g, lo, hi):
        g = g.copy()
        at = np.cumsum(rng.integers(lo, hi + 1, len(g) // lo))
        g[at[at < len(g)]] = 7
        return g
    for k, lo, hi in ((7, 20, 40), (13, 20, 40), (25, 10, 30)):
        own, part = contigs(small, lo, hi), contigs(_revcomp(small), lo, hi)
        runs.append((f"contigs of {lo}-{hi} bp, K={k}", codes(own),
                     codes(part), 0, None, len(small), k))
    own, part = small[:64].copy(), small[:64].copy()
    part[10:35] = own[:25]
    own[28] = part[9] = part[39] = 7
    runs.append(("64 bp, own starts 0-3 and 29-39, partner starts 10-14",
                 codes(own), codes(part), 0, None, 64, K))
    max_err = 0
    for label, own, part, lo, hi, gv, k in runs:
        kw = dict(K=k, G_valid=gv, d_lo=lo, d_hi=hi)
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
    _, own, part, lo, hi, gv, _ = runs[0]
    kw = dict(K=K, G_valid=gv, d_lo=lo, d_hi=hi)
    turns = []
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = sweep_plain if name == "plain" else sweep
        turns.append((name, _time_ms(torch, lambda: fn(own, part, **kw))))
    k_ms = [ms for n, ms in turns if n == "kernel"]
    p_ms = [ms for n, ms in turns if n == "plain"]
    kernel_ms, plain_ms = sum(k_ms) / 2, sum(p_ms) / 2
    pairs = time_sweep.pairs_of(G, K, lo, hi)
    floors = time_sweep.floors_ms(pairs, K)
    out_bytes = got.numel() * got.element_size()
    bound = max(floors["tensor_ms"],
                (own.numel() + part.numel() + out_bytes) / HBM_RATE * 1e3)
    print(f"sweep at G={G} K={K} d in [{lo}, {hi}) on {card}: kernel {k_ms} "
          f"ms, plain {p_ms} ms (turns plain, kernel, kernel, plain); "
          f"kernel {pairs / kernel_ms * 1e3} window pairs/s, plain "
          f"{pairs / plain_ms * 1e3} pairs/s; bound {bound} ms "
          f"({time_sweep.tensor_ops_per_pair(K)} int8 tensor operations a pair "
          f"at {INT8_PEAK / 1e12:g} TOP/s), kernel at {bound / kernel_ms} of "
          f"it; floor of the one-popcount-a-pair method {floors['popc_ms']} "
          f"ms; floor of the bit-sliced method "
          f"({time_sweep.ops_per_step(K)} + {time_sweep.LOOP_OPS} integer "
          f"instructions for {32 * time_sweep.LANE_WORDS} pairs) "
          f"{floors['sliced_ms']} ms")
    for row in time_sweep.time_slices(torch, sweep, seq):
        best = min(row["ms"])
        print(f"sweep slice timing on {card}: K={row['K']} {row['strand']}: "
              f"kernel {row['ms']} ms; bound {row['tensor_ms']} ms (int8 "
              f"tensor operations), least launch at "
              f"{row['tensor_ms'] / best} of it "
              f"({row['tensor_exact_ms'] / best} of the {row['tensor_exact_ms']} "
              f"ms of one-hot rows without padding); bit-sliced floor "
              f"{row['sliced_ms']} ms, popcount floor {row['popc_ms']} ms")
    return max_err, kernel_ms, plain_ms, bound


def sweep_engine(torch, dev, seq, oracle_genome, oracles, card):
    """Phase 6: the sweep engine end to end on the chrIV-length genome,
    against the max-match engine and the numpy oracles. Returns the sweep
    kernel's launches in the engine run and the max-match engine's
    minimum at every position."""
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
    want = want_mxu = hammings_exhaustive_mxu(seq, K, device=dev)
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
    return launches, want_mxu


def gather(torch, dev):
    """Phase 7: the gather profiler, the device times, then the kernel
    against its plain version with indices counted from the end and out of
    range, ragged tails and unaligned views. Returns (launches in the
    profiler run, max_abs_err, kernel ms and plain ms of device time per
    call, bound ms: the table, the indices and the output moved once)."""
    from kit4b_tpu_torch.kernels.take import FILL, take, take_plain
    from kit4b_tpu_torch.tools import profile_gather
    reset_launches()
    times = profile_gather.main()
    launches = take.launches
    if launches != profile_gather.CALLS + 1:
        raise AssertionError(f"the profiler launched the gather kernel "
                             f"{launches} times, not "
                             f"{profile_gather.CALLS + 1}")
    print(f"gather by CUDA events over {profile_gather.CALLS} host launches "
          f"(the host's launch rate, not device time): kernel "
          f"{times['ms']} ms, plain {times['plain_ms']} ms a call")
    dt = profile_gather.device_times(dev)
    by, key = ("torch.profiler", "us") if dt["kernel_us"] and dt["plain_us"] \
        else ("graph replay", "graph_us")   # a profiler without device time
    kernel_us, plain_us = dt[f"kernel_{key}"], dt[f"plain_{key}"]
    table, idx = profile_gather.inputs(dev)
    bound = sum(t.numel() * t.element_size()
                for t in (table, idx, idx)) / HBM_RATE * 1e3
    print(f"gather device time per call over {profile_gather.LAUNCHES} "
          f"calls: {dt} us; the kernels line takes {by}: kernel "
          f"{kernel_us} us, plain {plain_us} us; bound {bound * 1e3} us "
          f"(bytes), kernel at {bound * 1e3 / kernel_us} of it")
    for row in profile_gather.scaling(dev):
        print(f"gather device time by size: {row}")
    n = table.shape[0]
    edge = torch.tensor([-1, -n, -n - 1, n, n + 5], dtype=torch.int32,
                        device=dev)
    idx[:5] = edge
    ragged = torch.cat([idx, edge[:3]])
    cases = [("the profiler's indices", idx),
             (f"{len(ragged)} indices (ragged tail)", ragged),
             ("9 indices", torch.cat([edge, idx[5:9]]))]
    cases += [(f"a view {4 * k} bytes past a 16-byte boundary", ragged[k:])
              for k in (1, 2, 3)]
    max_err = 0
    for label, ix in cases:
        got, want = take(table, ix), take_plain(table, ix)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        print(f"take vs plain [{label}]: N={len(ix)} data_ptr % 16 = "
              f"{ix.data_ptr() % 16}: equal={torch.equal(got, want)} "
              f"max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel differs from plain: {label}")
    edges = take(table, idx)[:5].tolist()
    print(f"indices -1, -T, -T-1, T, T+5 read {edges}")
    if edges != [int(table[-1]), int(table[0]), FILL, FILL, FILL]:
        raise AssertionError("gather kernel misreads the edge indices")
    return launches, max_err, kernel_us / 1e3, plain_us / 1e3, bound


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


def max_matches(torch, dev, queries: np.ndarray, seq: np.ndarray, k: int,
                before: np.ndarray | None = None, chunk: int = 1 << 21):
    """For each query row (codes [n, k]), the most positions at which it
    equals one window of `seq` (codes; N equals nothing): all windows, or
    with `before` only those starting before before[i]. One-hot rows in
    fp16 on the card, exact for counts up to 2048, over chunks of
    windows."""
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    qh = torch.cat([q == b for b in range(4)], 1).half()
    s = torch.from_numpy(np.ascontiguousarray(seq)).to(dev)
    lim = None if before is None else torch.from_numpy(before).to(dev)
    best = torch.full((len(q),), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, len(seq) - k + 1, chunk):
        w = s[c0:c0 + chunk + k - 1].unfold(0, k, 1)
        m = qh @ torch.cat([w == b for b in range(4)], 1).half().T
        if lim is not None:
            cols = torch.arange(c0, c0 + w.shape[0], device=dev)
            m = torch.where(cols[None] < lim[:, None], m, -1)
        best = torch.maximum(best, m.amax(1).int())
    return best.cpu().numpy()


def kmarkers_golden(torch, dev):
    """Phase 9a: the port against the JAX package's kmarkers golden."""
    from kit4b_tpu_torch.tools import make_kmarkers_golden as mg
    gold = np.load(mg.GOLDEN)
    if mg.inputs_sha256() != str(gold["inputs_sha256"]):
        raise AssertionError("the kmarkers workload rebuilt here differs "
                             "from the one the golden was made from")
    find_markers, pass_codes, write_fa, _ = mg.port_fns(dev)
    t0 = time.perf_counter()
    out = mg.compute_kmarkers(find_markers, pass_codes, write_fa)
    wall = time.perf_counter() - t0
    bad = [k for k in out if not np.array_equal(out[k], gold[k])]
    tiers = {mh: out[f"tiers_e{mh}"].tolist() for mh in mg.MIN_HAMMINGS}
    counts = {mh: (len(out[f"markers_m0_e{mh}"]),
                   len(out[f"markers_m1_e{mh}"])) for mh in mg.MIN_HAMMINGS}
    print(f"kmarkers golden ({wall} s): positions of tiers 1, 2, 3 and "
          f"dropped by min_hamming {tiers}, markers -m 0 / -m 1 {counts}; "
          f"differs from the JAX golden in {bad or 'nothing'}")
    if bad:
        raise AssertionError(f"kmarkers differs from the JAX golden in {bad}")


def kmarkers_brute(torch, dev):
    """Phase 9b: the planted 3 x 6 kbp set of tests/test_golden_kmarkers.py
    (seed 3), accepted set against the brute force of the documented
    contract (numpy, by one-hot products)."""
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
    from kit4b_tpu_torch.kmer import kmarkers
    k, n = 50, 6000
    rng = np.random.default_rng(3)
    A, B, C = (rng.integers(0, 4, n).astype(np.uint8) for _ in range(3))

    def mutate(win, offsets):
        w = win.copy()
        for o in offsets:
            w[o] = (w[o] + rng.integers(1, 4)) % 4
        return w
    B[200:200 + k] = mutate(A[1000:1000 + k], [5])
    B[400:400 + k] = mutate(A[2000:2000 + k], [30, 40])
    g = Genome.from_records([SeqRecord(f"{c}.{c}", "", s) for c, s in
                             (("cultA", A), ("cultB", B), ("cultC", C))])
    markers = kmarkers.find_cultivar_markers(
        SfxIndex.build(g), np.arange(3, dtype=np.int32), 0, kmer_len=k,
        min_hamming=2, extend=False, batch=2048, device=dev)
    got = {m.start for m in markers if m.chrom.startswith("cultA")}

    def onehot(seq):
        w = np.lib.stride_tricks.sliding_window_view(seq, k)
        return np.concatenate([w == b for b in range(4)], 1) \
            .astype(np.float32)
    a1 = onehot(A)
    best = np.zeros(len(a1))
    for other in (B, C):
        for seq in (other, dna.revcomp(other)):
            best = np.maximum(best, (a1 @ onehot(seq).T).max(1))
    truth = set(np.nonzero(k - best >= 2)[0].tolist())
    print(f"kmarkers brute force (3 x {n} bp, K={k}, min_hamming 2): "
          f"{len(got)} accepted, brute force {len(truth)}, equal "
          f"{got == truth}; planted Hamming-1 at 1000 rejected "
          f"{1000 not in got}, Hamming-2 at 2000 accepted {2000 in got}")
    if got != truth or 1000 in got or 2000 not in got:
        raise AssertionError("kmarkers differs from the brute force")


def config3_cultivars(n=CONFIG3_LEN, cults=3):
    """tools/config3_wheat.py's cultivars (seed 33): a random backbone;
    each cultivar 0.2 % SNPs and a private 50 kbp block. Returns the codes
    and the block starts."""
    rng = np.random.default_rng(33)
    backbone = rng.integers(0, 4, n).astype(np.uint8)
    seqs, at = [], []
    for _ in range(cults):
        seq = backbone.copy()
        snps = rng.integers(0, n, n // 500)
        seq[snps] = (seq[snps] + rng.integers(1, 4, len(snps))) % 4
        priv = rng.integers(0, 4, 50_000).astype(np.uint8)
        a = int(rng.integers(0, n - 50_000))
        seq[a:a + 50_000] = priv
        seqs.append(seq)
        at.append(a)
    return seqs, at


def kmarkers_full(torch, dev, card, tmp: Path):
    """Phase 9c: config #3 at full size through the port's CLI."""
    from kit4b_tpu_torch import cli, dna
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
    from kit4b_tpu_torch.kmer import kmarkers
    k, mh = 50, 2
    seqs, at = config3_cultivars()
    specs = []
    for c, seq in enumerate(seqs):
        write_fasta(tmp / f"cult{c}.fa", [f"cult{c}_chr1"], [seq])
        specs.append(f"cult{c}={tmp / f'cult{c}.fa'}")
    out = tmp / "markers.fa"
    phases = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(phases)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["kmarkers", "-c", *specs, "-t", "cult0", "-K", str(k),
                   "-e", str(mh), "-m", "1", "-o", str(out)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    logging.getLogger("kit4b_tpu_torch").removeHandler(phases)
    if rc != 0:
        raise AssertionError(f"CLI kmarkers exited {rc}")
    n_pos = CONFIG3_LEN - k + 1
    print(f"CLI kmarkers -K {k} -e {mh} -m 1 on 3 x {CONFIG3_LEN} bp on "
          f"{card}: wall {wall} s, phases {phases.seconds}; "
          f"{n_pos / phases.seconds['markers']} K-mers/s in the markers "
          f"phase; positions by tier {phases.tiers}; peak device memory "
          f"{peak} bytes")

    heads = [ln.split()[1].split("|") for ln in out.read_text().splitlines()
             if ln.startswith(">")]
    acc = np.zeros(n_pos, bool)
    for chrom, start, length in heads:
        if chrom != "cult0.cult0_chr1":
            raise AssertionError(f"a marker on {chrom}")
        acc[int(start):int(start) + int(length) - k + 1] = True
    block = acc[at[0]:at[0] + 50_000 - k + 1].mean()
    print(f"markers: {len(heads)} ({int(acc.sum())} accepted positions); "
          f"cult0's private block at {at[0]}: {block} of its windows "
          f"accepted")
    if block < 0.99:
        raise AssertionError(f"only {block} of the private block accepted")

    # sampled positions against a direct on-card computation
    rng = np.random.default_rng(SEED + 9)
    pos = np.concatenate([rng.choice(np.nonzero(acc)[0], 128, replace=False),
                          rng.choice(np.nonzero(~acc)[0], 128,
                                     replace=False)])
    q = np.lib.stride_tricks.sliding_window_view(seqs[0], k)[pos]
    t0 = time.perf_counter()
    near = k - np.max([max_matches(torch, dev, q, s, k) for c in (1, 2)
                       for s in (seqs[c], dna.revcomp(seqs[c]))], axis=0)
    dup = np.max([max_matches(torch, dev, w, seqs[0], k, before=pos)
                  for w in (q, q[:, ::-1] ^ 3)], axis=0) == k
    want = (near >= mh) & ~dup
    print(f"sample check ({time.perf_counter() - t0} s): 128 accepted and "
          f"128 rejected positions; direct minimum distance to cult1/cult2 "
          f"of the accepted min {int(near[:128].min())}, of the rejected "
          f"max {int(near[128:].max())}; rejected as an in-target duplicate "
          f"{int((dup[128:] & (near[128:] >= mh)).sum())}; disagree "
          f"{int((want != acc[pos]).sum())}")
    if (want != acc[pos]).any():
        bad = pos[want != acc[pos]]
        raise AssertionError(f"kmarkers disagrees with the direct "
                             f"computation at {bad[:5]}")

    # the pass on the CLI's shapes: the first two batches on card and CPU,
    # then timed; the whole marker run under torch.profiler
    t0 = time.perf_counter()
    g, cc, _ = kmarkers.build_pseudogenome(
        {f"cult{c}": [tmp / f"cult{c}.fa"] for c in range(len(seqs))})
    print(f"pseudo-genome from the FASTA files (the CLI's parse): "
          f"{time.perf_counter() - t0} s")
    if not np.array_equal(g.seq, Genome.from_records(
            [SeqRecord("", "", s) for s in seqs]).seq):
        raise AssertionError("the pseudo-genome differs from the cultivars")
    t0 = time.perf_counter()
    idx = SfxIndex.build_buckets(g)     # kmarkers reads no in-bucket order
    print(f"bucket index of the pseudo-genome (native counting sort, lut_k "
          f"{idx.lut_k}): {time.perf_counter() - t0} s")
    kw = dict(K=k, genome_len=len(g.seq),
              offsets=kmarkers.core_offsets(k, mh, idx.lut_k), lut_k=idx.lut_k,
              n_compact=24, max_ml=48, min_hamming=mh, target=0)
    got = []
    for d in (dev, torch.device("cpu")):
        tens = (*kmarkers._fast_device_arrays(idx, k, d),
                torch.from_numpy(g.seq).to(d),
                torch.from_numpy(g.starts.astype(np.int32)).to(d),
                torch.from_numpy(cc).to(d))
        t0 = time.perf_counter()
        got.append([kmarkers.kmarkers_pass(*tens, torch.arange(
            b * KM_BATCH, (b + 1) * KM_BATCH, dtype=torch.int32, device=d),
            **kw).cpu().numpy() for b in (0, 1)])
        print(f"first two {KM_BATCH}-position batches on {d}: "
              f"{time.perf_counter() - t0} s")
        if d == dev:
            qp = torch.arange(KM_BATCH, dtype=torch.int32, device=d)
            ms = sorted(_time_ms(torch, lambda: kmarkers.kmarkers_pass(
                *tens, qp, **kw)) for _ in range(5))
            del tens
    same = all(np.array_equal(a, b) for a, b in zip(*got))
    print(f"their codes equal on card and CPU: {same} (codes "
          f"{np.unique(np.concatenate(got[0]), return_counts=True)})")
    if not same:
        raise AssertionError("the card and the CPU differ on config #3's "
                             "first batches")
    print(f"kmarkers_pass on {KM_BATCH} resident positions on {card}: "
          f"median {ms[2]} ms of 5 (CUDA events: {ms}), "
          f"{KM_BATCH / ms[2] * 1e3} K-mers/s")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kmarkers.marker_positions(idx, cc, 0, kmer_len=k, min_hamming=mh,
                                  device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    print(f"marker run under torch.profiler on {card}: wall {wall} s, "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             f"{sum(e.count for e in device)} device operations" if busy
             else "device busy not measured (the profiler showed no "
                  "device time)"))


def restricted_golden(torch, dev):
    """Phase 10a: restricted hammings against the JAX package's golden."""
    from kit4b_tpu_torch.tools import make_kmarkers_golden as mg
    gold = np.load(mg.GOLDEN)
    out = mg.compute_restricted(mg.port_fns(dev)[3])
    bad = [k for k in out if not np.array_equal(out[k], gold[k])]
    print(f"restricted golden: {len(out)} genomes, minima "
          f"{ {k: int(v.min()) for k, v in out.items()} }; differs from the "
          f"JAX golden in {bad or 'nothing'}")
    if bad:
        raise AssertionError(f"restricted hammings differs from the JAX "
                             f"golden in {bad}")


def restricted_rule(got, want, clean, mh, w):
    """Positions of clean windows that break the restricted rule: equal to
    the true minimum where it is at most w - 1, else in [min(true, mh + 1),
    mh + 1]."""
    got, want = got.astype(np.int64), want.astype(np.int64)
    low = want <= w - 1
    ok = np.where(low, got == want,
                  (got >= np.minimum(want, mh + 1)) & (got <= mh + 1))
    return np.nonzero(clean & ~ok)[0]


def restricted_chr4(torch, dev, seq, want, card):
    """Phase 10b: -r 1 and -r 3 on the chrIV-length genome against phase
    6's max-match minimum at every window of A/C/G/T only."""
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import Genome
    from kit4b_tpu_torch.kmer.hammings import hammings_restricted
    G = len(seq)
    idx = SfxIndex.build(Genome(["chrIV"], np.array([0]),
                                np.array([G - 1]), seq))
    nk = G - K + 1
    clean = np.zeros(G, bool)
    clean[:nk] = ~(np.lib.stride_tricks.sliding_window_view(seq, K) >= 4) \
        .any(1)
    w = min(4, K // idx.lut_k)
    for mh in (1, 3):
        t0 = time.perf_counter()
        got = hammings_restricted(idx, K, max_hamming=mh, device=dev)
        wall = time.perf_counter() - t0
        bad = restricted_rule(got, want, clean, mh, min(mh + 1, w))
        exact = int((got[clean] == want[clean]).sum())
        print(f"hammings_restricted -r {mh} on {G} bp (lut_k "
              f"{idx.lut_k}, W {min(mh + 1, w)}) on {card}: {wall} s, "
              f"{nk / wall} K-mer rows/s; {int(clean.sum())} A/C/G/T "
              f"windows, {exact} equal to the true minimum, "
              f"{len(bad)} break the rule")
        if len(bad):
            raise AssertionError(f"-r {mh} breaks the rule at {bad[:5]}: "
                                 f"{got[bad[:5]]} vs {want[bad[:5]]}")
        if mh == 1 and not np.array_equal(got[clean],
                                          np.minimum(want[clean], 2)):
            raise AssertionError("-r 1 differs from min(true, 2)")


def restricted_full(torch, dev, card, tmp: Path, chroms, seq, Gp):
    """Phase 10c: `hammings -r 3 -K 25` on the R64-length genome through
    the CLI, 500 sampled A/C/G/T windows against a direct on-card
    minimum."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.kmer.hammings import read_hmg
    from kit4b_tpu_torch.index.sfx_index import pick_lut_k
    mh = 3
    fa, out = tmp / "r64_synthetic.fa", tmp / "r3.hmg"
    write_fasta(fa, [f"chr{r}" for r in ROMAN], chroms)
    phases = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(phases)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["hammings", "-i", str(fa), "-o", str(out), "-K", str(K),
                   "-r", str(mh)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    logging.getLogger("kit4b_tpu_torch").removeHandler(phases)
    if rc != 0:
        raise AssertionError(f"CLI hammings -r exited {rc}")
    G = len(seq)
    nk = G - K + 1
    print(f"CLI hammings -r {mh} -K {K} on {G - 16} bp on {card}: wall "
          f"{wall} s, phases {phases.seconds}; {nk / phases.seconds['sweep']} "
          f"K-mer rows/s in the sweep phase (index build included); peak "
          f"device memory {peak} bytes")
    names, dists = read_hmg(out)
    starts = np.cumsum([0] + [len(c) + 1 for c in chroms[:-1]])
    rng = np.random.default_rng(SEED + 10)
    sel = []
    while len(sel) < 500:
        c = int(rng.choice(16, p=np.array(R64_LENGTHS) / sum(R64_LENGTHS)))
        o = int(rng.integers(0, R64_LENGTHS[c] - K + 1))
        if (chroms[c][o:o + K] < 4).all():
            sel.append((c, o))
    got = np.array([dists[c][o] for c, o in sel], np.uint16)
    pos = np.array([starts[c] + o for c, o in sel], np.int64)
    t0 = time.perf_counter()
    want = direct_node_min(torch, dev, seq, pos, 0, Gp, Gp, batch=4)
    print(f"direct minimum over all {Gp} columns of both strands: "
          f"{time.perf_counter() - t0} s")
    w = min(mh + 1, K // pick_lut_k(G))
    bad = restricted_rule(got, want, np.ones(len(sel), bool), mh, w)
    print(f"sample check: 500 A/C/G/T windows, W {w}: {len(bad)} break the "
          f"rule; {int((got == want).sum())} equal to the true minimum; "
          f"true minima at most {w - 1}: {int((want <= w - 1).sum())}")
    if names != [f"chr{r}" for r in ROMAN] or len(bad):
        raise AssertionError(f"hammings -r breaks the rule at {pos[bad[:5]]}"
                             f": {got[bad[:5]]} vs {want[bad[:5]]}")


def pe_golden(torch, dev):
    """Phase 11a: paired-end kalign against the JAX package's golden."""
    from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg
    gold = np.load(mg.GOLDEN)
    g, idx, reads = mg.workload()
    if mg.inputs_sha256(g, reads) != str(gold["inputs_sha256"]):
        raise AssertionError("the PE golden workload rebuilt here differs "
                             "from the one the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns(dev), g, idx, reads)
    wall = time.perf_counter() - t0
    bad = [k for k in gold.files
           if k != "inputs_sha256" and not np.array_equal(out[k], gold[k])]
    stages = {f"{L} bp, -U {m}": dict(zip(mg.STAGE_KEYS,
                                          out[f"stages_{L}_{m}"].tolist()))
              for L in mg.READS for m in mg.MODES}
    print(f"PE golden ({wall} s; pairs {dict(mg.READS)}, -b {mg.BATCH}): "
          f"pair rows by stage {stages}; differs from the JAX golden in "
          f"{bad or 'nothing'} (tier-1 rows, stage counts, PePair stream, "
          f"SAM and VCF SHA-256)")
    if bad or mg.check_reach(out):
        raise AssertionError(f"PE kalign differs from the JAX golden in "
                             f"{bad}; reach {mg.check_reach(out)}")


def _profiled(torch, fn):
    """(wall s, device busy s or None, device operations) of fn() under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e6
    return wall, busy or None, sum(e.count for e in device)


def _vcf_calls(path: Path):
    """{(chrom, 0-based locus): first ALT code} of a VCF."""
    calls = {}
    for line in path.read_text().splitlines():
        if line.startswith("#"):
            continue
        c = line.split("\t")
        calls[c[0], int(c[1]) - 1] = "ACGT".find(c[4][0])
    return calls


def pe_full(torch, dev, card, tmp: Path):
    """Phase 11b: BASELINE config #4 at full size through the port's CLI
    (index, simreads -p, kalign -u), then its passes timed."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import kalign, pe
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import read_seqs
    from kit4b_tpu_torch.ops import pe_packed, seed_extend_fast
    from kit4b_tpu_torch.ops.seed_extend_deep import deep_pe_pass_planes
    from kit4b_tpu_torch.sim import simreads
    from kit4b_tpu_torch.tools.config4 import make_chr21_like
    t0 = time.perf_counter()
    seq, n = make_chr21_like(CONFIG4_MBP)
    fa, kix = tmp / "chr21s.fa", tmp / "chr21s.kix"
    write_fasta(fa, ["chr21s"], [seq[:n]])
    r1, r2, bed = tmp / "r1.fa", tmp / "r2.fa", tmp / "snps.bed"
    sam, vcf = tmp / "pe.sam", tmp / "pe.vcf"
    print(f"config #4 genome (make_chr21_like({CONFIG4_MBP}), seed 21, "
          f"{n} bp, {int((seq == 4).sum())} N) written: "
          f"{time.perf_counter() - t0} s")
    phases = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(phases)
    walls = {}
    for name, argv in (
            ("index", ["index", "-i", str(fa), "-o", str(kix)]),
            ("simreads", ["simreads", "-i", str(fa), "-o", str(r1), "-O",
                          str(r2), "-p", "-n", str(PE_PAIRS), "-l",
                          str(PE_LEN), "-j", "250", "-J", "600", "-e",
                          "illumina", "-z", "0.01", "-N", "1000", "-u",
                          str(bed), "-S", "9"]),
            ("kalign", ["kalign", "-i", str(r1), "-I", str(kix), "-o",
                        str(sam), "-u", str(r2), "-U", "1", "-d", "200",
                        "-D", "700", "-b", str(PE_BATCH), "-S", str(vcf)])):
        if name == "kalign":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        walls[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI {name} exited {rc}")
        if name == "kalign":
            peak = torch.cuda.max_memory_allocated()
        else:
            print(f"CLI {name}: {walls[name]} s, phases {phases.seconds}")
    logging.getLogger("kit4b_tpu_torch").removeHandler(phases)
    align = phases.seconds["align"]
    print(f"CLI kalign -u -U 1 -d 200 -D 700 -b {PE_BATCH} -S on {card}: "
          f"wall {walls['kalign']} s, phases {phases.seconds}; "
          f"{2 * PE_PAIRS / align} reads/s in the align phase, "
          f"{2 * PE_PAIRS / walls['kalign']} reads/s of the wall; pairs "
          f"{phases.pe_stats}; pair rows by stage {phases.pe_stages}; peak "
          f"device memory {peak} bytes")

    # the SAM against the reads' truth, the VCF against the planted SNPs
    qn, flag, rname, pos, _, _ = _sam_body(sam)
    proper = (flag & 2) != 0
    at_truth = 0
    for i in np.nonzero(proper)[0]:
        t = simreads.parse_truth(qn[i])
        at_truth += rname[i] == t["chrom"] and pos[i] - 1 == t["start"]
    truth = {}
    for line in bed.read_text().splitlines():
        c = line.split("\t")
        truth[c[0], int(c[1])] = "ACGT".index(c[3][2])
    calls = _vcf_calls(vcf)
    hit = sum(truth.get(k) == a for k, a in calls.items())
    n_acc = phases.pe_stats["accepted"]
    print(f"SAM check: {len(qn)} records, {int(proper.sum())} mates of "
          f"{n_acc} accepted pairs, {at_truth / max(int(proper.sum()), 1)} "
          f"of them at their truth locus; SNPs: {len(truth)} planted, "
          f"{len(calls)} called, {hit} true: sensitivity "
          f"{hit / max(len(truth), 1)}, precision {hit / max(len(calls), 1)}")
    if n_acc < 0.8 * PE_PAIRS or at_truth < 0.98 * int(proper.sum()):
        raise AssertionError(f"{n_acc} pairs accepted, {at_truth} of "
                             f"{int(proper.sum())} mates at their truth")

    idx = SfxIndex.load(kix)
    recs1, recs2 = list(read_seqs(r1)), list(read_seqs(r2))
    c1 = np.stack([r.codes for r in recs1])
    c2 = np.stack([r.codes for r in recs2])
    names = [r.name for r in recs1]

    def pal_on(d):
        return pe.PeAligner(kalign.KAligner(idx, batch_size=PE_BATCH,
                                            device=d),
                            pair_min_len=200, pair_max_len=700, pe_mode=1)

    def keys(stream):
        return [(a.name, b.name, pp.nar,
                 *((r.strand, r.pos, r.mm) if r else () for r in
                   (pp.r1, pp.r2)), pp.tlen, pp.rescued)
                for a, b, pp in stream]

    # the first two batches (one superbatch group) on the card and the CPU
    n2 = 2 * PE_BATCH
    got = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        got.append(keys(pal_on(d).align_pairs_arrays(c1[:n2], c2[:n2],
                                                     names[:n2])))
        print(f"first {n2} pairs on {d}: {time.perf_counter() - t0} s")
    if got[0] != got[1]:
        bad = next(i for i, (a, b) in enumerate(zip(*got)) if a != b)
        raise AssertionError(f"card and CPU differ at pair {bad}: "
                             f"{got[0][bad]} vs {got[1][bad]}")
    print(f"their PePair streams equal on card and CPU: True "
          f"({sum(k[2] == 'accepted' for k in got[0])} accepted)")

    # pinned against pageable uploads in turns, then the align phase
    # profiled
    def run(pal):
        return keys(pal.align_pairs_arrays(c1, c2, names))
    pinned_upload = pe._upload

    def pageable_upload(a, d):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)
    secs = {"pageable": [], "pinned": []}
    streams = []
    try:
        for kind in ("pageable", "pinned", "pinned", "pageable"):
            pe._upload = pinned_upload if kind == "pinned" else \
                pageable_upload
            t0 = time.perf_counter()
            streams.append(run(pal_on(dev)))
            secs[kind].append(time.perf_counter() - t0)
    finally:
        pe._upload = pinned_upload
    pal = pal_on(dev)
    wall, busy, n_ops = _profiled(torch, lambda: run(pal))
    n_batches = -(-PE_PAIRS // PE_BATCH)
    same = all(s == streams[0] for s in streams)
    print(f"align_pairs on all {PE_PAIRS} pairs on {card}, in turns "
          f"pageable, pinned, pinned, pageable: pageable uploads "
          f"{secs['pageable']} s, pinned non-blocking uploads "
          f"{secs['pinned']} s (streams equal: {same}); under "
          f"torch.profiler wall {wall} s, "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured (the profiler showed "
                          "no device time), ")
          + f"{n_ops} device operations ({n_ops / n_batches} a batch)")
    if not same:
        raise AssertionError("pinned uploads changed the output")

    # the three passes timed on the first batch's resident data
    al = pal.al
    ctx = pal._pctx
    L = PE_LEN
    a1, a2 = c1[:PE_BATCH], c2[:PE_BATCH]
    up = [pe._upload(x, dev) for a in (a1, a2)
          for x in kalign.pack_reads_2bit(a)]
    kw = dict(genome_len=len(idx.genome.seq), offsets=ctx["offsets"],
              lut_k=idx.lut_k, read_len=L, n_compact=al.n_compact,
              n_extend=al.n_extend, max_ml=al.max_ml, max_tot=ctx["max_tot"],
              mm_delta=al.mm_delta, min_ins=200, max_ins=700)
    args = (ctx["gview"], ctx["sa"], ctx["lut2"], ctx["starts_d"])

    def tier1(tier2):
        return pe_packed.pe_pass_packed(*args, *up, tier2=tier2, tier3=None,
                                        **kw)
    t2 = (min(PE_BATCH, pal.tier2[0]),) + pal.tier2[1:]
    n_t2 = n_past = 0
    for b0 in range(0, PE_PAIRS, PE_BATCH):     # tier counts of every batch
        ub = [pe._upload(x, dev) for a in (c1[b0:b0 + PE_BATCH],
                                           c2[b0:b0 + PE_BATCH])
              for x in kalign.pack_reads_2bit(a)]
        for tier, cnt in ((None, "t1"), (t2, "t2")):
            rows = pe_packed.unpack_rows12(pe_packed.pe_pass_packed(
                *args, *ub, tier2=tier, tier3=None, **kw).cpu().numpy())
            k = int((rows[:, 5] == pe_packed.PAIR_OVERFLOW).sum())
            n_t2 += k if cnt == "t1" else 0
            n_past += k if cnt == "t2" else 0
    print(f"pair rows by tier over the {n_batches} batches: tier 1 "
          f"{PE_PAIRS}, to tier 2 {n_t2}, past tier 2 {n_past}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tier1(t2)
        up2 = [pe._upload(x, dev) for x in kalign.pack_reads_2bit(a1)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del up2
    print("pe_pass_packed and its pinned uploads, once warm, under "
          "torch.cuda.set_sync_debug_mode('error'): no call waited for the "
          "device")
    ms_pass = sorted(_time_ms(torch, lambda: tier1(t2)) for _ in range(5))
    from kit4b_tpu_torch.ops.seed_extend_v4 import words_from_2bit
    planes = (words_from_2bit(up[0], up[1], L),
              words_from_2bit(up[2], up[3], L))
    rows = pe_packed.unpack_rows12(tier1(t2).cpu().numpy())
    ovf = np.nonzero(rows[:, 5] == pe_packed.PAIR_OVERFLOW)[0]
    rng = np.random.default_rng(SEED + 11)
    sel = np.concatenate([ovf, rng.integers(0, PE_BATCH, 4096)])[:4096]
    idxs = torch.from_numpy(sel.astype(np.int32)).to(dev)
    dkw = pal._deep_kw()
    deep_ms = {}
    for d1, d2 in ((True, False), (True, True)):
        deep_ms[d1, d2] = sorted(_time_ms(torch, lambda: deep_pe_pass_planes(
            *args, *planes, idxs, deep1=d1, deep2=d2, **dkw))
            for _ in range(5))
    R = PE_BATCH
    win = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, PE_BATCH, R), rng.integers(1, 3, R),
        rng.integers(0, 2, R), rng.integers(0, n - 1000, R))]
    scan = sorted(_time_ms(torch, lambda: seed_extend_fast.window_scan_pe(
        ctx["gview"], *planes, *win, genome_len=len(idx.genome.seq),
        scan_len=700 - 200 + 1, read_len=L)) for _ in range(5))
    print(f"passes on {card} (CUDA events, median of 5): pe_pass_packed on "
          f"{PE_BATCH} resident pairs {ms_pass[2]} ms {ms_pass} "
          f"({len(ovf)} rows past its tier 2); deep_pe_pass_planes at E "
          f"4096, budget {pal._DEEP_BLOCKS} rarest {pal._DEEP_N_SEL}: deep "
          f"mate 1 {deep_ms[True, False][2]} ms {deep_ms[True, False]}, "
          f"both mates {deep_ms[True, True][2]} ms {deep_ms[True, True]}; "
          f"window_scan_pe at R {R}, 501 positions {scan[2]} ms {scan}")


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
    """Keeps the unrounded seconds of the CLI's PhaseTimer phases,
    kalign's class counts and tier-1 pass by read length, paired-end
    kalign's pair counts and pair rows by stage, and kmarkers' positions by
    tier."""

    def __init__(self):
        super().__init__()
        self.seconds = {}
        self.stats = self.tier1 = self.tiers = None
        self.pe_stats = self.pe_stages = None

    def emit(self, record):
        if record.msg == "phase %s: %.2fs":
            self.seconds[record.args[0]] = record.args[1]
        elif str(record.msg).startswith("kalign: %d reads"):
            self.stats, self.tier1 = record.args[1], record.args[2]
        elif str(record.msg).startswith("kalign PE: %s"):
            self.pe_stats, self.pe_stages = record.args[0], record.args[1]
        elif str(record.msg).startswith("kmarkers: positions by tier"):
            self.tiers = record.args[0]


def main() -> int:
    import torch
    t_start = time.perf_counter()
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
        log = build.paths(k)[2].read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        print(f"  ptxas {k}: {len(regs)} entry functions, registers "
              f"{sorted(set(regs))}")
        for line in log.splitlines():
            if any(w in line for w in ("wgmma", "warning")):
                print(f"  ptxas {k}:", line.strip())
        kinds = "spill stores|spill loads" if k == "minmm" \
            else "stack frame|spill stores|spill loads"
        spills = [line.strip() for line in log.splitlines()
                  if re.search(rf"[1-9][0-9]* bytes ({kinds})", line)]
        print(f"  ptxas {k}: lines with {kinds.replace('|', ', ')}: "
              f"{spills or 'none'}")
        if spills:
            raise AssertionError(f"{k} spills or keeps a stack frame: "
                                 f"{spills}")

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
    sweep_launches, chr4_min = sweep_engine(torch, dev, chr4, g,
                                            oracle_results, card)
    take_launches, take_err, take_ms, take_plain_ms, take_bound = gather(
        torch, dev)

    # --- 8. kalign: the JAX golden, then config #1 at full size -------
    kalign_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        kalign_full(torch, dev, card, Path(tmp))

    # --- 9. kmarkers: the JAX golden, the brute force, config #3 ------
    kmarkers_golden(torch, dev)
    kmarkers_brute(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        kmarkers_full(torch, dev, card, Path(tmp))

    # --- 10. hammings -r: the golden, chrIV, the R64-length CLI run ----
    restricted_golden(torch, dev)
    restricted_chr4(torch, dev, chr4, chr4_min, card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        restricted_full(torch, dev, card, Path(tmp), chroms, seq, Gp)

    # --- 11. paired-end kalign: the JAX golden, config #4 at full size --
    pe_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        pe_full(torch, dev, card, Path(tmp))
    if "jax" in sys.modules or "kit4b_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package kit4b_tpu was imported")

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start} s")
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
