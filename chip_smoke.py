#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kit4b_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It imports nothing of jax or of the JAX package kit4b_tpu. Each phase
raises on failure, and the script then exits non-zero without printing a
result:

1. The card's name and power limit (nvidia-smi), the CUDA version, and the
   build of the kernels (csrc/minmm.cu, sweep.cu, take.cu, sw.cu; one nvcc
   each, all at once) with ptxas's report; none may spill, and none but
   minmm may keep a stack frame.
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
   reads of 100 bp, Illumina-skewed 2 % substitutions) written as FASTA
   (the reads also as FASTQ, for 16c), then the port's CLI `index` and
   `kalign -b 98304 -M 1`. Checks: the v5
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
12. Full-stats kalign (plain PyTorch passes on the card, rescues on the
   host). (a) The port on the seeded workload of
   `kit4b_tpu_torch.tools.make_kalign_full_golden` (two chromosomes of
   200 kbp in all with repeat islands, introns and N runs; InDel, artefact,
   spliced and chimeric reads of 100 and 75 bp; pairs whose mate 2 is cut
   to 72-100 bp) against the JAX package's committed golden: per rescue mode
   (-y, -l, -C, all three) nar/pos/strand/mm, CIGARs, orphan demotions and
   the SAM's SHA-256, the ladder's tier counts, the raw hit lists, and the
   PePair stream and SAM of pe modes 1-4, all equal. (b) Config #1's
   genome, 100,000 reads from the CLI `simreads -e illumina -z 0.02 -X
   0.05 -x 3 -a 0.02 -S 7`, through `kalign -y 20 -C 50 -b 98304 -M 1`
   under torch.profiler, its align phase split by the functions that take
   the time (device passes with their collect, the three rescues, the
   results, the orphan removal, write_sam). Checks: >= 99.9 % of accepted
   reads at their truth locus (chromosome, strand, aligned span over the
   truth). Prints the InDel reads placed with their I/D CIGAR before and
   after the orphan removal, and `fast_pass_v3` on 98,304 resident reads
   beside `fast_pass_packed_v5` (CUDA events, median of 5). (c) The same
   genome with 2,000 introns planted and 20,000 spliced reads (both
   strands, 10 a junction) through `kalign -l 10000`: the same figures and
   the spliced reads accepted with their N CIGAR at the truth junction.
   (d) Phase 11b's index and pairs, mate 2 cut to a seeded length in
   100-150 bp, through `kalign -u -U 2`: reads/s, accepted pairs, mates at
   their truth locus (>= 98 %).
13. kalign's options, BAM, the SNP side outputs and bisulfite alignment
   (host phases, plain PyTorch passes). (a) The port's CLI on the seeded
   workload of `kit4b_tpu_torch.tools.make_kalign_opts_golden` (21 runs:
   -x, -6, --mlmode 2-5, --lociconstraints, -Z, -z, -B, -5, BAM unsorted
   and with a BAI or a CSI, -S -g -3 -X --markerfile --snpcentroidfile,
   genpba, the paired-end route, index -m 1 + kalign --bisulfite) against
   the JAX package's committed golden: every array equal; the raw BGZF
   bytes only where this machine's zlib wrote the golden (it prints which).
   (b) Config #1's genome and phase 8b's reads through `kalign -x 10 -6 2
   --mlmode 3 -Z ^ecoli -5 4 -o out.bam --baindex`, under torch.profiler,
   the run split by phase (passes, phases, filters, BAM write and sort)
   and function; the same run to SAM, whose records, sorted, must equal
   the BAM's, and 1,000 random windows queried through the BAI, each
   returning exactly the records that overlap it. (c) The same genome,
   `simreads -n 920000 -N 1000` (about 20x), `kalign -S out.vcf -g -3 -X
   --markerfile --snpcentroidfile`: wall, `snp call`, SNP recall and
   precision against the planted SNPs. (d) `index -m 1` on that genome
   (lut_k 16: two radix-3 LUTs of 3^16 + 1 entries), the build split into
   SA-IS, LUTs and the .kbx write; `kalign --bisulfite` on 100,000
   converted 100 bp reads: reads/s, accepted share and truth share; one
   `bs_pass_compact` on 16,384 resident reads (CUDA events, median of 5),
   its device operations and busy share.
14. Config #5 and the float device uses (host numpy and kalign, the
   near-duplicate pass and two float32 products in plain PyTorch). (a) The
   port's CLI and functions on the seeded workload of
   `kit4b_tpu_torch.tools.make_assembly_golden` (filter with and without
   -a, -D 2 on the card, -d, -c 2, a -k resume; assemb SE and -u with -P;
   mergeoverlaps on FASTA and FASTQ; scaffold; pescaffold on the port's
   kalign SAMs; rnaexpr, genmlds, sarscov2ml; filter_assemble,
   merge_pe_to_se and one `_overlap_pass` batch) against the JAX package's
   committed golden: every array equal, rnaexpr's floats within its
   tolerance. (b) BASELINE config #5 at BASELINE.md's size: 1 Mbp at 25x
   from `tools/config5.py` (83,333 pairs of 2 x 150 and 8,333 duplicated),
   through the CLI `filter`, `assemb -y 60 -Y 40`, `index` and `kalign` of
   each mate file onto the contigs, `pescaffold`, `scaffold --minctg 100`,
   and the fused `filter_assemble`, each timed with its PhaseTimer split;
   every output's SHA-256 equal to the JAX package's full run recorded in
   the golden, and scaffolds that join contigs. Prints the reads removed,
   the contigs of at least 300 bp, how many of the 20 longest are exact
   substrings of the genome, the multi-contig scaffolds and peak device
   memory. (c) `filter -D 2` on those reads under torch.profiler (its
   device busy share), then one `_overlap_pass` on 8,192 queries of its
   corpus (CUDA events, median of 5; device operations and busy share),
   equal to the CPU pass. (d) `rnaexpr` on 96 samples x 30,000 genes in
   replicate pairs with three label swaps, r within 1e-5 of numpy's
   float64 and the planted inconsistencies found; `sarscov2ml` on 10,000
   isolates x 400 features, its co-support counts exact and the three
   planted linked groups found.

15. The PacBio long-read path (the banded Smith-Waterman kernels of
   csrc/sw.cu, host code around them). (a) The port on the seeded inputs
   of `kit4b_tpu_torch.tools.make_pacbio_golden` (the engine's edge cases:
   band edges, pad rows, N codes, equal peaks, every caller's score set and
   a tie of gap costs, bands of 1 to 4,097, walks cut at L_OPS; and small
   readsets through correct_reads, filter_reads, assemble and
   polish_contigs) against the JAX package's committed golden: every array
   equal, pointer bytes included. (b) The cluster's own costs: one
   cluster barrier, one DSMEM load and one shared-memory load, timed on
   clusters of 2, 4 and 8 blocks. Both kernels against their plain
   versions on the golden's cases, on the cases built to break the
   cluster scan and the tiled walk
   (`kit4b_tpu_torch.tools.sw_cluster_cases`: ties across rows and
   blocks, gap runs across warp and block edges, band edges, bands 1 to
   8,192, batches 1 to 200 (every cluster size), every stop rule; random
   pointer bytes for the walk) and on the three caller shapes of
   `tools/time_sw.py` (15b's B 32, W 3,000, Lp 4,096 of CLR reads;
   `pbassemb`'s B 32, W 256, Lp 16,384 of corrected reads; `pbfilter`'s
   B 16, W 512, Lp 16,384 of hairpins), the whole pointer array and every
   output equal. Each shape timed (CUDA events, median of 5) beside the
   plain versions, its layout (cluster size, columns a thread) and how many
   of its clusters the card holds at once, the scan's bounds (35 int32
   operations a cell, SW_CELL_OPS; and the instructions a cell of the
   kernel's own inner loop, from `cuobjdump -sass`), the traceback's bytes
   bound and the floor of its serial walk. (c) tools/pacbio_scale.py's
   readset (100 kbp at
   8x, seed 99: 59 reads of 10-18 kbp spans at about 14 % CLR error; one
   in ten folded into a hairpin) through the CLI `pbfilter`, `ecreads -l
   10000 -L 5000 -b 3000`, `pbassemb` and `eccontigs`, each step's wall
   split into index build, candidates, hairpin seeds, SW scan, traceback
   and consensus, with its SW batches, kernel launches (one scan and one
   traceback a batch), device busy share and peak memory. Checks: every
   planted hairpin split, at least 80 % of the reads of 10 kbp or more
   corrected, their median SW identity to the truth at least 0.1 above the
   raw reads', a contig; ecreads' first and longest SW batches held to the
   plain versions; the four outputs' SHA-256 equal to PB_SHA256, what the
   parent commit's kernels wrote.
16. blitz, hrdx, kmerdist and the scorer group (host code, the SW kernels
   through blitz's gapped refinement, kalign's passes). (a) The port's CLI
   on the seeded workload of `kit4b_tpu_torch.tools.make_longtail_golden`
   (blitz's small set of edge cases and its big set of 200 queries of 1-16
   kbp on a 1 Mbp genome, gapped and `--no-gapped`; hrdx; kmerdist on a MAF
   of blitz's hits; benchmark modes 0-4; alignsbs; ngsqc -H -; maploci;
   rnade) against the JAX package's committed golden: every file equal byte
   for byte. (b) Config #1's genome through the CLI `index`, then 1,000
   planted queries of 1-16 kbp (1 % substitutions, InDels of 10-40 bp, both
   strands) and 50 random ones through the CLI `blitz` (one SW batch a
   query) and `blitz --no-gapped`: the gapped wall split into seeding,
   chaining, SW scan, traceback, the rest of the SW batches, the block walk
   and the PSL write, with its SW launches, device busy share and peak
   memory. Checks: every planted query's best hit on its strand, within 50
   bp of its truth, spanning 90 % of it, its InDel carried to the base (at
   most a pair of extra 1-base gaps); no random query hit; every block's
   bases against the genome giving the PSL's matches and mismatches; the
   longest query's and the median query's SW batches held to the plain
   versions and timed beside their bounds. (c) hrdx on two 2 Mbp haplotypes
   cut into contigs of 5-60 kbp with 20 unique ones; kmerdist on a MAF of
   (b)'s hits against a direct count; 8b's 100,000 reads and the mapped
   records of its SAM (what kalign writes of them at -M 0) -> benchmark
   -m 4 (>= 99.9 % of aligned reads at their truth), -m 1 -> -m 2 ->
   kalign -> -m 3, -m 0; alignsbs (2,000 queries, 200 targets of 2 kbp,
   10 bootstraps; iteration 0 against a direct overlap count); ngsqc -H -;
   maploci against a direct count over 500 features; rnade on two kalign
   SAMs against 200 genes; each step timed.
17. The PBA and haplotype family (host numpy, kalign's passes on the
   card). (a) The port's CLI on the seeded workload of
   `kit4b_tpu_torch.tools.make_haplotypes_golden` (every mode of
   callhaplotypes, pbautils, snpmarkers, snps2pgsnps, lochap2bed,
   markerseqs, repassemb, pangenome, seghaplotypes, gbsmapsnps and dgts,
   59 runs) against the JAX package's committed golden: every text file
   byte for byte, every .npz array by array. (b) `haplotypes_full`:
   founder A is config #1's genome, founder B A with 0.5 % seeded SNPs,
   four progeny mosaics of A and B in segments of 100-500 kbp, the last
   with a heterozygous run; each sample's error-free reads at 5x through
   the CLI `kalign -S -3` on the card, then every command of the family on
   the PBAs, the SNP CSVs and a progeny aligned to the A + B pangenome,
   each step timed and held to the planted truth (its docstring lists the
   checks and the cuts).

Each kernel's launch counter is set to 0 just before its path (phases 4, 6,
7, each CLI step of 15c and 16b's gapped `blitz`) and read just after it;
phases 8-14 and 17 run none of the kernels. The script prints its
seconds, and
each phase's, before the kernels line. The line before the last is a JSON
table of the kernels, each with its bound (the least time the card could
take: int8 tensor operations for minmm and sweep, int32 operations for
sw_scan, bytes for take and sw_traceback; take's `ms` is device time); the
last line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import logging
import os
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
SPLICE_INTRONS, SPLICE_READS = 2_000, 20_000   # phase 12c, 10 reads each
SNP_READS = 920_000    # phase 13c: 100 bp reads, about 20x of 4.6 Mbp
BIS_READS, BS_BATCH = 100_000, 16_384   # phase 13d
OVL_BATCH = 8_192      # phase 14c: the near-duplicate pass's queries
RNA_GENES, RNA_SAMPLES = 30_000, 96      # phase 14d: rnaexpr
RNA_SWAPS = ((4, 17), (30, 61), (70, 91))   # sample labels swapped
ML_ROWS, ML_FEATS = 10_000, 400          # phase 14d: sarscov2ml
ML_GROUPS = ((5, 300), (5, 200), (5, 150))   # planted: features, rows
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


def _with_ms(torch, fn):
    """(fn(), its milliseconds by CUDA events)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _time_ms(torch, fn) -> float:
    """Milliseconds of one call of fn, timed with CUDA events."""
    return _with_ms(torch, fn)[1]


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


def config1_files(cfg1: Path) -> tuple[Path, Path]:
    """Config #1's genome FASTA and its .kix, as 8b writes them."""
    return cfg1 / "ecoli_sim.fa", cfg1 / "ecoli_sim.kix"


def config1_reads(cfg1: Path) -> tuple[Path, Path, Path]:
    """Config #1's 100,000 reads (simreads -e illumina -z 0.02 -S 7) as
    FASTA and as FASTQ (with their qualities), and 8b's `kalign -M 1` SAM
    of the FASTA, as 8b writes them."""
    return cfg1 / "reads.fa", cfg1 / "reads.fq", cfg1 / "out.sam"


def kalign_full(torch, dev, card, cfg1: Path):
    """Phase 8b: config #1 at full size through the port's CLI; its genome,
    the CLI `index`'s .kix, the reads (FASTA and FASTQ) and the SAM are
    written into `cfg1`, where the later phases on this genome (12b,
    13b-d, 16b-c, 17b) find them."""
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
    fa, kix = config1_files(cfg1)
    reads_fa, reads_fq, sam = config1_reads(cfg1)
    write_fasta(fa, ["ecoli_sim"], [codes])
    simreads.write_reads(reads_fa, recs)
    simreads.write_reads(reads_fq, recs, "fastq")

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


def kalign_full_golden(torch, dev):
    """Phase 12a: the full-stats path against the JAX package's golden."""
    from kit4b_tpu_torch.tools import make_kalign_full_golden as mg
    gold = np.load(mg.GOLDEN)
    g, idx, se, pairs = mg.workload()
    if mg.inputs_sha256(g, se, pairs) != str(gold["inputs_sha256"]):
        raise AssertionError("the full-stats golden workload rebuilt here "
                             "differs from the one the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns(dev), g, idx, se, pairs)
    wall = time.perf_counter() - t0
    bad = [k for k in gold.files
           if k != "inputs_sha256" and not np.array_equal(out[k], gold[k])]
    print(f"full-stats golden ({wall} s; {len(se)} reads, "
          f"{len(pairs[0])} pairs of unequal mates, -b {mg.BATCH}): "
          f"accepted by mode "
          f"{ {m: int((out[f'nar_{m}'] == 0).sum()) for m in mg.MODES} }, "
          f"CIGARs with I, D, N, S "
          f"{ {m: out[f'n_cigar_{m}'].tolist() for m in mg.MODES} }, "
          f"tiers {out['tiers'].tolist()}; differs from the JAX golden in "
          f"{bad or 'nothing'} (nar/pos/strand/mm, CIGARs, orphans, SAM, "
          f"tier counts, raw hit lists, PePair streams and PE SAM)")
    if bad or mg.check_reach(out):
        raise AssertionError(f"the full-stats path differs from the JAX "
                             f"golden in {bad}; reach {mg.check_reach(out)}")


@contextlib.contextmanager
def _timed(targets, nested=False):
    """Seconds spent in each (label, owner, attribute) function for the
    run inside; a call made while another timed call runs counts in the
    outer one only, or, with `nested`, in every one it passes through."""
    secs = {label: 0.0 for label, _, _ in targets}
    depth = [0]
    saved = [(owner, name, getattr(owner, name))
             for _, owner, name in targets]

    def wrap(label, fn):
        def timed(*a, **kw):
            if depth[0] and not nested:
                return fn(*a, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                secs[label] += time.perf_counter() - t0
                depth[0] -= 1
        return timed
    for (label, owner, name), (_, _, fn) in zip(targets, saved):
        setattr(owner, name, wrap(label, fn))
    try:
        yield secs
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def _sam_records(path: Path):
    """(qname, flag, rname, 0-based pos, CIGAR, read length) of a SAM's
    records."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith("@"):
                c = line.split("\t", 10)
                out.append((c[0], int(c[1]), c[2], int(c[3]) - 1, c[5],
                            len(c[9])))
    return out


def _ref_span(cigar: str) -> int:
    return sum(int(n) for n, op in re.findall(r"(\d+)([MDN])", cigar))


def _rescue_cli(torch, dev, card, argv, n_reads, label):
    """One CLI kalign run with a rescue on, under torch.profiler, its align
    phase split by the functions that take the time. Returns the run's
    (_PhaseLog, wall s, orphan removal's snapshots by kind)."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import kalign, phases
    al = kalign.KAligner
    before = {}
    remove = phases.remove_orphan_junctions

    def remove_spy(aligned, kind):
        before[kind] = [(rec.name, res.pos, res.strand, res.cigar)
                        for rec, res in aligned
                        if res.nar == "accepted" and res.cigar]
        return remove(aligned, kind)
    targets = [("device passes and their collect", al, "_submit"),
               ("device passes and their collect", al, "_collect_raw"),
               ("results", al, "_to_results"),
               ("indel rescue", al, "_indel_rescue"),
               ("splice rescue", al, "_splice_rescue"),
               ("chimeric rescue", al, "_chimeric_rescue"),
               ("orphan removal", phases, "remove_orphan_junctions"),
               ("write_sam", kalign, "write_sam")]
    log = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(log)
    phases.remove_orphan_junctions = remove_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc = []
    try:
        with _timed(targets) as secs:
            wall, busy, n_ops = _profiled(
                torch, lambda: rc.append(cli.main(argv)))
    finally:
        phases.remove_orphan_junctions = remove
        logging.getLogger("kit4b_tpu_torch").removeHandler(log)
    peak = torch.cuda.max_memory_allocated()
    if rc != [0]:
        raise AssertionError(f"CLI {label} exited {rc}")
    # the per-record route times the passes, the phases and the writer
    # apart; together they are the aligning of the readset
    align = sum(log.seconds.get(k, 0) for k in ("align", "phases", "write"))
    print(f"CLI {label} on {card}: wall {wall} s ({n_reads / wall} reads/s), "
          f"phases {log.seconds}; align phase {n_reads / align} reads/s, "
          f"split {secs}, the rest of it (parsing on its thread, lists) "
          f"{align - sum(secs.values())} s; "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured (the profiler showed "
                          "no device time), ")
          + f"{n_ops} device operations; peak device memory {peak} bytes; "
          f"classes {log.stats}; tier 1 {log.tier1}")
    return log, wall, before


def _truth_share(records, truth_of):
    """(accepted, at their truth locus): same chromosome and strand, the
    aligned reference span overlapping the truth span."""
    acc = at = 0
    for qn, flag, rname, pos, cigar, _ in records:
        if flag & 4:
            continue
        acc += 1
        chrom, t0, t1, strand = truth_of(qn)
        at += (rname == chrom and (flag & 16 != 0) == (strand == "-")
               and pos <= t1 and pos + _ref_span(cigar) > t0)
    return acc, at


def rescue_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phases 12b and 12c: config #1's genome with InDel and artefact reads
    through `kalign -y 20 -C 50`, then with introns planted and spliced
    reads through `kalign -l 10000`; the full-stats pass timed beside v5."""
    from kit4b_tpu_torch import cli, dna
    from kit4b_tpu_torch.align import kalign
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import read_seqs
    from kit4b_tpu_torch.ops import seed_extend_v3
    from kit4b_tpu_torch.sim import simreads
    rng = np.random.default_rng(12345)
    codes = rng.integers(0, 4, ECOLI_LEN).astype(np.uint8)
    fa, kix = config1_files(cfg1)
    reads_fa, sam = tmp / "reads.fa", tmp / "out.sam"
    t0 = time.perf_counter()
    if cli.main(["simreads", "-i", str(fa), "-o", str(reads_fa), "-n",
                 str(ECOLI_READS), "-l", str(READ_LEN), "-e", "illumina",
                 "-z", "0.02", "-X", "0.05", "-x", "3", "-a", "0.02", "-S",
                 "7"]) != 0:
        raise AssertionError("CLI simreads exited non-zero")
    print(f"config #1 genome (4.6 Mbp, default_rng(12345), 8b's index): "
          f"{ECOLI_READS} reads simulated (-X 0.05 -x 3 -a 0.02): "
          f"{time.perf_counter() - t0} s")

    # --- 12b: -y 20 -C 50 --------------------------------------------
    argv = ["kalign", "-i", str(reads_fa), "-I", str(kix), "-o", str(sam),
            "-y", "20", "-C", "50", "-b", str(ECOLI_BATCH), "-M", "1"]
    _, _, before = _rescue_cli(torch, dev, card, argv, ECOLI_READS,
                               f"kalign -y 20 -C 50 -b {ECOLI_BATCH} -M 1")
    recs = _sam_records(sam)
    truth = {r[0]: simreads.parse_truth(r[0]) for r in recs}

    def truth_of(qn):
        t = truth[qn]
        return t["chrom"], t["start"], t["end"], t["strand"]
    acc, at = _truth_share(recs, truth_of)
    indel = {qn for qn, t in truth.items() if t["indel"]}

    def indel_ok(qn, pos, cigar):
        t = truth[qn]
        ops = re.findall(r"(\d+)([ID])", cigar or "")
        return (len(ops) == 1 and pos == t["start"]
                and ops[0] == (str(abs(t["indel"])),
                               "D" if t["indel"] > 0 else "I"))
    pre = sum(indel_ok(qn, pos, cig) for qn, pos, _, cig in before["indel"])
    post = sum(qn in indel and indel_ok(qn, pos, cigar)
               for qn, flag, _, pos, cigar, _ in recs if not flag & 4)
    n_cig = {op: sum(op in r[4] for r in recs if not r[1] & 4)
             for op in "IDS"}
    print(f"SAM check: {len(recs)} records, {acc} accepted ({acc / len(recs)}"
          f"), {at / acc} of them at their truth locus (same chromosome and "
          f"strand, aligned span overlapping the truth); CIGARs with I, D, "
          f"S {n_cig}; of the {len(indel)} InDel reads, "
          f"{pre / len(indel)} accepted with their I/D CIGAR at the truth "
          f"offset by the rescue, {post / len(indel)} in the SAM after the "
          f"orphan removal (a microInDel seen by one read only is demoted)")
    if len(recs) != ECOLI_READS or at < 0.999 * acc:
        raise AssertionError(f"{at} of {acc} accepted reads at their truth "
                             "locus")

    # the full-stats pass on its own, beside v5, on the first batch
    idx = SfxIndex.load(kix)
    batch = np.stack([r.codes for _, r in zip(range(ECOLI_BATCH),
                                               read_seqs(reads_fa))])
    al = kalign.KAligner(idx, batch_size=ECOLI_BATCH, device=dev)
    gview, sa, _, lut2 = al._device_for(READ_LEN)
    _, mtm = al.schedule_for(READ_LEN)
    r2b, nlist = (torch.from_numpy(a).to(dev)
                  for a in kalign.pack_reads_2bit(batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def v3():
        return seed_extend_v3.fast_pass_v3(
            gview, sa, lut2, r2b, nlist, genome_len=len(idx.genome.seq),
            offsets=al._offsets_for(READ_LEN, mtm), lut_k=idx.lut_k,
            read_len=READ_LEN, n_compact=al.n_compact, max_ml=al.max_ml,
            n_extend=al.n_extend)
    n_ovf = int(v3()["overflow"].sum())
    ms_v3 = sorted(_time_ms(torch, v3) for _ in range(5))
    peak_v3 = torch.cuda.max_memory_allocated()
    _, _, run_v5 = kalign_escalations(torch, al, batch)
    ms_v5 = sorted(_time_ms(torch, run_v5) for _ in range(5))
    print(f"fast_pass_v3 on {ECOLI_BATCH} device-resident reads on {card}: "
          f"median {ms_v3[2]} ms of 5 (CUDA events: {ms_v3}), "
          f"{ECOLI_BATCH / ms_v3[2] * 1e3} reads/s, {n_ovf} reads overflow "
          f"to the host ladder, peak device memory {peak_v3} bytes; "
          f"fast_pass_packed_v5 on the same reads {ms_v5[2]} ms {ms_v5}")

    # --- 12c: introns planted, spliced reads, -l 10000 -----------------
    spl = codes.copy()
    dons = 10_000 + 2_250 * np.arange(SPLICE_INTRONS)
    gaps = 200 + (37 * np.arange(SPLICE_INTRONS)) % 1_800
    spl[dons] = 2                                   # GT donor
    spl[dons + 1] = 3
    spl[dons + gaps - 2] = 0                        # AG acceptor
    spl[dons + gaps - 1] = 2
    fa2, kix2 = tmp / "ecoli_introns.fa", tmp / "ecoli_introns.kix"
    reads2, sam2 = tmp / "spliced.fa", tmp / "spliced.sam"
    write_fasta(fa2, ["ecoli_sim"], [spl])
    names, rows = [], []
    for i, (don, gap) in enumerate(zip(dons.tolist(), gaps.tolist())):
        for k in range(SPLICE_READS // SPLICE_INTRONS):
            split = 30 + (7 * i + 9 * k) % 41
            r = np.concatenate([spl[don - split:don],
                                spl[don + gap:don + gap + READ_LEN - split]])
            strand = "-+"[k % 2]
            rows.append(r if strand == "+" else dna.revcomp(r))
            names.append(f"sj|{don - split}|{split}|{gap}|{strand}")
    write_fasta(reads2, names, rows)
    if cli.main(["index", "-i", str(fa2), "-o", str(kix2)]) != 0:
        raise AssertionError("CLI index of the intron genome exited "
                             "non-zero")
    argv = ["kalign", "-i", str(reads2), "-I", str(kix2), "-o", str(sam2),
            "-l", "10000", "-b", str(ECOLI_BATCH), "-M", "1"]
    _rescue_cli(torch, dev, card, argv, len(rows),
                f"kalign -l 10000 -b {ECOLI_BATCH} -M 1 ({len(rows)} spliced "
                f"reads on {SPLICE_INTRONS} introns)")
    recs = _sam_records(sam2)

    def sj_truth(qn):
        _, s, split, gap, strand = qn.split("|")
        return ("ecoli_sim", int(s), int(s) + READ_LEN + int(gap) - 1,
                strand)
    acc, at = _truth_share(recs, sj_truth)
    n_sj = 0
    for qn, flag, _, pos, cigar, _ in recs:
        _, s, split, gap, _ = qn.split("|")
        m = re.fullmatch(r"(\d+)M(\d+)N(\d+)M", cigar)
        n_sj += bool(m and not flag & 4 and pos == int(s)
                     and m.group(2) == gap)
    print(f"SAM check: {len(recs)} records, {acc} accepted, {at / max(acc, 1)}"
          f" of them at their truth locus; {n_sj / len(recs)} of the spliced "
          f"reads accepted with an N CIGAR at their truth junction")
    if len(recs) != len(rows) or at < 0.999 * acc or not n_sj:
        raise AssertionError(f"spliced reads: {at} of {acc} accepted at "
                             f"their truth, {n_sj} with their junction")


def pe_unequal_full(torch, dev, card, tmp: Path):
    """Phase 12d: phase 11b's index and pairs with mate 2 cut to a seeded
    length in 100-150 bp, through `kalign -u -U 2`."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.io.fasta import read_seqs, write_fasta as wf
    from kit4b_tpu_torch.sim import simreads
    r2 = list(read_seqs(tmp / "r2.fa"))
    cut = np.random.default_rng(SEED + 12).integers(100, PE_LEN + 1, len(r2))
    for rec, n in zip(r2, cut.tolist()):
        rec.codes = rec.codes[:n]
    r2u, sam = tmp / "r2_cut.fa", tmp / "pe_cut.sam"
    wf(r2u, r2)
    log = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["kalign", "-i", str(tmp / "r1.fa"), "-I",
                       str(tmp / "chr21s.kix"), "-o", str(sam), "-u",
                       str(r2u), "-U", "2", "-d", "200", "-D", "700", "-b",
                       str(PE_BATCH)])
    finally:
        logging.getLogger("kit4b_tpu_torch").removeHandler(log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"CLI kalign -u of unequal mates exited {rc}")
    recs = _sam_records(sam)
    proper = [r for r in recs if r[1] & 2]
    at = 0
    for qn, flag, rname, pos, _, n in proper:
        t = simreads.parse_truth(qn)
        want = t["start"] + (t["len"] - n if t["strand"] == "-" else 0)
        at += rname == t["chrom"] and pos == want
    n_acc = log.pe_stats["accepted"]
    print(f"CLI kalign -u -U 2 -d 200 -D 700 -b {PE_BATCH} on {PE_PAIRS} "
          f"pairs, mate 2 cut to 100-{PE_LEN} bp, on {card}: wall {wall} s, "
          f"phases {log.seconds}; {2 * PE_PAIRS / log.seconds['align']} "
          f"reads/s in the align phase, {2 * PE_PAIRS / wall} of the wall; "
          f"pairs {log.pe_stats}; {len(proper)} mates of accepted pairs, "
          f"{at / max(len(proper), 1)} of them at their truth locus; peak "
          f"device memory {peak} bytes")
    if n_acc < 0.8 * PE_PAIRS or at < 0.98 * len(proper):
        raise AssertionError(f"{n_acc} pairs accepted, {at} of "
                             f"{len(proper)} mates at their truth")


def opts_golden(torch, dev):
    """Phase 13a: kalign's options, genpba and bisulfite alignment through
    the port's CLI on the card against the JAX package's golden."""
    import zlib
    from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
    gold = np.load(mg.GOLDEN)
    w = mg.workload()
    if mg.inputs_sha256(*w) != str(gold["inputs_sha256"]):
        raise AssertionError("the options golden workload rebuilt here "
                             "differs from the one the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_main(), ["--device", str(dev)], *w)
    wall = time.perf_counter() - t0
    same_zlib = str(gold["zlib_version"]) == zlib.ZLIB_RUNTIME_VERSION
    keys = [k for k in gold.files if k not in ("inputs_sha256",
                                               "zlib_version")]
    skipped = [k for k in keys if k.endswith(":raw") and not same_zlib]
    bad = [k for k in keys if k not in skipped
           and not np.array_equal(out[k], gold[k])]
    print(f"options golden ({wall} s; {len(mg.GROUPS) + 2} CLI runs: "
          f"{', '.join(mg.GROUPS)}, genpba, bisulfite): zlib here "
          f"{zlib.ZLIB_RUNTIME_VERSION}, the golden's {gold['zlib_version']}"
          f": " + ("raw BAM/BAI/CSI bytes compared" if same_zlib else
                   f"raw BGZF bytes not comparable, {len(skipped)} compared "
                   "as decompressed payload and decoded index only")
          + f"; {len(keys) - len(skipped)} arrays compared, differing: "
          f"{bad or 'none'}")
    if bad or mg.check_reach(out):
        raise AssertionError(f"kalign options differ from the JAX golden in "
                             f"{bad}; reach {mg.check_reach(out)}")


def _reg2bins(beg: int, end: int) -> list[int]:
    """The BAI bins that may hold records overlapping [beg, end) (SAM
    spec 5.3)."""
    end -= 1
    bins = [0]
    for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins += range(first + (beg >> shift), first + (end >> shift) + 1)
    return bins


def bai_queries(bam: Path, n_windows: int, length: int, rng) -> int:
    """Every query over n_windows random windows through the BAI (bins,
    chunks and the linear index, offsets mapped to record ordinals) returns
    exactly the records that overlap the window. Returns the records the
    queries found."""
    from kit4b_tpu_torch.io.bam import read_bam
    from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
    recs = list(read_bam(bam))
    beg = np.array([r.pos - 1 for r in recs], np.int64)
    end = beg + np.array([_ref_span(r.cigar) for r in recs], np.int64)
    rows = mg.decode_bai(Path(str(bam) + ".bai").read_bytes(),
                         mg.ordinal_map(bam))
    rows = rows[rows[:, 0] == 0]
    chunks = rows[rows[:, 1] >= 0]
    linear = rows[rows[:, 1] < 0][:, 3]
    found = 0
    for a in rng.integers(0, length, n_windows).tolist():
        b = a + int(rng.integers(1, 5_000))
        lo = int(linear[min(a >> 14, len(linear) - 1)]) if len(linear) \
            else 0
        cand = set()
        for _, _, o0, o1 in chunks[np.isin(chunks[:, 1], _reg2bins(a, b))]:
            cand.update(range(max(int(o0), lo), int(o1)))
        got = {k for k in cand if beg[k] < b and end[k] > a}
        want = set(np.nonzero((beg < b) & (end > a))[0].tolist())
        if got != want:
            raise AssertionError(f"BAI query [{a}, {b}) returns "
                                 f"{len(got)} records, {len(want)} overlap")
        found += len(got)
    return found


def opts_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phase 13b: config #1 (8b's reads) with the phases, the filters and a
    sorted BAM with its BAI, beside the same run written as SAM."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import kalign
    from kit4b_tpu_torch.io import bam as bam_io
    from kit4b_tpu_torch.sim import simreads
    kix = config1_files(cfg1)[1]
    reads_fa = config1_reads(cfg1)[0]
    flags = ["-x", "10", "-6", "2", "--mlmode", "3", "-Z", "^ecoli", "-5",
             "4", "-b", str(ECOLI_BATCH)]
    al = kalign.KAligner
    targets = [("device passes and their collect", al, "_submit"),
               ("device passes and their collect", al, "_collect_raw"),
               ("results", al, "_to_results"),
               ("BAM records", bam_io.BamWriter, "write"),
               ("BAI", bam_io, "write_bai")]
    runs = {}
    for out in (tmp / "out.bam", tmp / "out.sam"):
        log = _PhaseLog()
        logging.getLogger("kit4b_tpu_torch").addHandler(log)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rc = []
        argv = ["kalign", "-i", str(reads_fa), "-I", str(kix), "-o",
                str(out), *flags] + (["--baindex"] if out.suffix == ".bam"
                                     else [])
        try:
            with _timed(targets) as secs:
                wall, busy, n_ops = _profiled(
                    torch, lambda: rc.append(cli.main(argv)))
        finally:
            logging.getLogger("kit4b_tpu_torch").removeHandler(log)
        if rc != [0]:
            raise AssertionError(f"CLI kalign -> {out.name} exited {rc}")
        runs[out.suffix] = (log, wall, busy, n_ops, dict(secs),
                            torch.cuda.max_memory_allocated())
    log, wall, busy, n_ops, secs, peak = runs[".bam"]
    print(f"CLI kalign {' '.join(flags)} -o out.bam --baindex on {card}: "
          f"wall {wall} s ({ECOLI_READS / wall} reads/s), phases "
          f"{log.seconds} (align = passes, collect and results; phases = "
          f"-6, -x, --mlmode 3; filters = -Z, -5; write = BAM write and "
          f"sort, BAI), align {ECOLI_READS / log.seconds['align']} reads/s; "
          f"split {secs}; "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured, ")
          + f"{n_ops} device operations; peak device memory {peak} bytes; "
          f"classes {log.stats}; the same run to SAM: wall {runs['.sam'][1]}"
          f" s, phases {runs['.sam'][0].seconds}")
    # the BAM's records, sorted, are the SAM's records sorted alike
    bam_lines = [r.line() for r in bam_io.read_bam(tmp / "out.bam")]
    with open(tmp / "out.sam") as f:
        sam = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
    sam_sorted = sorted(sam, key=lambda ln: int(ln.split("\t", 4)[3]))
    recs_sam = _sam_records(tmp / "out.sam")
    truth = {r[0]: simreads.parse_truth(r[0]) for r in recs_sam}
    acc, at = _truth_share(recs_sam, lambda qn: (
        truth[qn]["chrom"], truth[qn]["start"], truth[qn]["end"],
        truth[qn]["strand"]))
    n_trim = sum("S" in r[4] for r in recs_sam)
    found = bai_queries(tmp / "out.bam", 1_000, ECOLI_LEN,
                        np.random.default_rng(SEED + 13))
    print(f"BAM check: {len(bam_lines)} records, equal to the SAM's "
          f"{len(sam)} once sorted: {bam_lines == sam_sorted}; {n_trim} "
          f"trimmed (S CIGAR); {at / max(acc, 1)} of {acc} accepted at "
          f"their truth locus; 1,000 BAI window queries returned exactly "
          f"the {found} overlapping records")
    if bam_lines != sam_sorted or at < 0.99 * acc or not n_trim:
        raise AssertionError("the sorted BAM differs from the SAM, or the "
                             f"truth share {at} / {acc} is low")


def snp_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phase 13c: config #1's genome with planted SNPs at about 20x
    through kalign -S -g -3 -X --markerfile --snpcentroidfile."""
    from kit4b_tpu_torch import cli
    fa, kix = config1_files(cfg1)
    reads, bed = tmp / "snp_reads.fa", tmp / "snps.bed"
    t0 = time.perf_counter()
    if cli.main(["simreads", "-i", str(fa), "-o", str(reads), "-n",
                 str(SNP_READS), "-l", str(READ_LEN), "-e", "illumina",
                 "-z", "0.01", "-N", "1000", "-u", str(bed), "-S",
                 "13"]) != 0:
        raise AssertionError("CLI simreads -N 1000 exited non-zero")
    t_sim = time.perf_counter() - t0
    out = {k: tmp / k for k in ("snp.sam", "out.vcf", "cov.wig",
                                "out.pba.npz", "m.fa", "c.csv")}
    log = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli.main([
            "kalign", "-i", str(reads), "-I", str(kix), "-o",
            str(out["snp.sam"]), "-b", str(ECOLI_BATCH), "-S",
            str(out["out.vcf"]), "-g", str(out["cov.wig"]), "-3",
            str(out["out.pba.npz"]), "-X", str(tmp / "dsnp"),
            "--markerfile", str(out["m.fa"]), "--snpcentroidfile",
            str(out["c.csv"])])
    finally:
        logging.getLogger("kit4b_tpu_torch").removeHandler(log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"CLI kalign with the SNP outputs exited {rc}")
    truth = {}
    for line in bed.read_text().splitlines():
        c = line.split("\t")
        truth[c[0], int(c[1])] = "ACGT".index(c[3][2])
    calls = _vcf_calls(out["out.vcf"])
    hit = sum(truth.get(k) == a for k, a in calls.items())
    lines = {k: sum(1 for _ in open(p)) for k, p in out.items()
             if k not in ("snp.sam", "out.pba.npz")}
    for k in ("dsnp.disnp.csv", "dsnp.trisnp.csv"):
        lines[k] = sum(1 for _ in open(tmp / k))
    print(f"simreads -n {SNP_READS} -N 1000 ({t_sim} s), then CLI kalign -S "
          f"-g -3 -X --markerfile --snpcentroidfile on {card}: wall {wall} s"
          f" ({SNP_READS / wall} reads/s), phases {log.seconds}; classes "
          f"{log.stats}; peak device memory {peak} bytes; SNPs: "
          f"{len(truth)} planted, {len(calls)} called, {hit} true: recall "
          f"{hit / max(len(truth), 1)}, precision {hit / max(len(calls), 1)};"
          f" lines written {lines}")
    if hit < 0.9 * len(truth) or hit < 0.95 * len(calls) \
            or lines["m.fa"] < 2 or lines["dsnp.disnp.csv"] < 2:
        raise AssertionError(f"SNPs: {hit} true of {len(calls)} called, "
                             f"{len(truth)} planted; {lines}")


def bisulfite_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phase 13d: index -m 1 on config #1's genome, then kalign
    --bisulfite on converted reads; one bs_pass_compact timed."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import bisulfite as bs
    from kit4b_tpu_torch.align.kalign import build_pass_schedule
    from kit4b_tpu_torch.index import sfx_index
    from kit4b_tpu_torch.io.fasta import Genome
    from kit4b_tpu_torch.ops import seed_extend_fast as F
    from kit4b_tpu_torch.tools.make_kalign_opts_golden import bis_convert
    fa, kbx = config1_files(cfg1)[0], tmp / "ecoli_sim.kbx"
    reads, sam = tmp / "bis.fa", tmp / "bis.sam"
    ilog = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(ilog)
    try:
        with _timed([("SA-IS", sfx_index, "build_suffix_array")]) as secs:
            t0 = time.perf_counter()
            rc = cli.main(["index", "-m", "1", "-i", str(fa), "-o",
                           str(kbx)])
            wall_index = time.perf_counter() - t0
    finally:
        logging.getLogger("kit4b_tpu_torch").removeHandler(ilog)
    if rc != 0:
        raise AssertionError(f"CLI index -m 1 exited {rc}")
    build = ilog.seconds["build bisulfite index"]
    g = Genome.load(fa)
    rng = np.random.default_rng(SEED + 14)
    pos = rng.integers(0, ECOLI_LEN - READ_LEN, BIS_READS)
    strand = rng.integers(0, 2, BIS_READS)
    rows = [bis_convert(g.seq[p:p + READ_LEN], s, rng)
            for p, s in zip(pos.tolist(), strand.tolist())]
    write_fasta(reads, [f"bs{i}|{p}|{s}" for i, (p, s) in
                        enumerate(zip(pos.tolist(), strand.tolist()))], rows)
    log = _PhaseLog()
    logging.getLogger("kit4b_tpu_torch").addHandler(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc = []
    try:
        wall, busy, n_ops = _profiled(torch, lambda: rc.append(cli.main(
            ["kalign", "--bisulfite", "-i", str(reads), "-I", str(kbx),
             "-o", str(sam)])))
    finally:
        logging.getLogger("kit4b_tpu_torch").removeHandler(log)
    peak = torch.cuda.max_memory_allocated()
    if rc != [0]:
        raise AssertionError(f"CLI kalign --bisulfite exited {rc}")
    recs = _sam_records(sam)
    at = 0
    for qn, flag, rname, p0, _, _ in recs:
        _, p, s = qn.split("|")
        at += p0 == int(p) and bool(flag & 16) == (s == "1")
    print(f"CLI index -m 1 on {ECOLI_LEN} bp on {card}: wall {wall_index} "
          f"s; build {build} s (SA-IS x2 {secs['SA-IS']} s, the radix-3 "
          f"LUTs and keys {build - secs['SA-IS']} s), .kbx write "
          f"{ilog.seconds['write index']} s; kalign --bisulfite on "
          f"{BIS_READS} converted reads of {READ_LEN} bp: wall {wall} s "
          f"({BIS_READS / wall} reads/s); accepted {len(recs) / BIS_READS},"
          f" {at / max(len(recs), 1)} of them at their truth locus and "
          f"strand; "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured, ")
          + f"{n_ops} device operations; peak device memory {peak} bytes")
    if len(recs) < 0.8 * BIS_READS or at < 0.999 * len(recs):
        raise AssertionError(f"bisulfite: {len(recs)} accepted, {at} at "
                             "their truth")

    # one pass on 16,384 resident reads
    idx = bs.BsIndex.load(kbx)
    al = bs.BsAligner(idx, device=dev)
    (gct, sct, lct), (gga, sga, lga) = al._device(READ_LEN)
    r = torch.from_numpy(np.stack(rows[:BS_BATCH])).to(dev)
    rc_ = F.revcomp_device(r)
    r_ct, r_garc = torch.where(r == 1, 3, r), torch.where(rc_ == 2, 0, rc_)
    _, mtm = build_pass_schedule(READ_LEN, al.max_subs, al.mm_delta,
                                 len(idx.genome.seq))

    def run():
        return bs.bs_pass_compact(
            gct, sct, lct, gga, sga, lga, r_ct, r_garc,
            genome_len=len(idx.genome.seq),
            offsets=F.fast_offsets(READ_LEN, idx.lut_k, mtm),
            lut_k=idx.lut_k, n_compact=al.n_compact, max_tot_mm=mtm,
            mm_delta=al.mm_delta)
    first = run().cpu().numpy()
    ms = sorted(_time_ms(torch, run) for _ in range(5))
    pwall, pbusy, pops = _profiled(torch, run)
    print(f"bs_pass_compact on {BS_BATCH} device-resident reads on {card}: "
          f"median {ms[2]} ms of 5 (CUDA events: {ms}), "
          f"{BS_BATCH / ms[2] * 1e3} reads/s; {pops} device operations a "
          f"pass, device busy {pbusy} s of {pwall} s; rows by code (-3 "
          f"overflow, -2 multi, -1 no hit): "
          f"{ {c: int((first[:, 0] == c).sum()) for c in (-3, -2, -1)} }")


@contextlib.contextmanager
def _cli_step(steps: dict, name: str):
    """Records (wall seconds, _PhaseLog) of the CLI run inside in
    steps[name]."""
    log = _PhaseLog()
    logger = logging.getLogger("kit4b_tpu_torch")
    logger.addHandler(log)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.removeHandler(log)
    steps[name] = (time.perf_counter() - t0, log)


def _contig_stats(path: Path, genome: str, genome_rc: str) -> dict:
    """Config5_bacterial.py's figures of a contig FASTA: the contigs of at
    least 300 bp (count, longest, N50, total) and how many of the 20
    longest sequences are exact substrings of the genome on either
    strand."""
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.io.fasta import read_seqs
    seqs = sorted((dna.decode(r.codes) for r in read_seqs(path)), key=len,
                  reverse=True)
    big = [len(x) for x in seqs if len(x) >= 300]
    acc, n50 = 0, 0
    for ln in big:
        acc += ln
        if 2 * acc >= sum(big):
            n50 = ln
            break
    exact = sum(x in genome or x in genome_rc for x in seqs[:20])
    return {"sequences": len(seqs), "contigs >= 300 bp": len(big),
            "longest": big[0] if big else 0, "N50": n50,
            "total": sum(big), "exact of the 20 longest": exact}


def _multi_contig(path: Path) -> int:
    """Scaffolds of a scaffold FASTA that join two contigs or more."""
    from kit4b_tpu_torch.io.fasta import read_seqs
    return sum("," in r.descr for r in read_seqs(path))


def assembly_golden(torch, dev):
    """Phase 14a: config #5's commands, the fused route, merge_pe_to_se,
    one overlap pass and the float commands through the port on the card
    against the JAX package's golden."""
    from kit4b_tpu_torch.tools import make_assembly_golden as mg
    gold = np.load(mg.GOLDEN)
    w = mg.workload()
    if mg.inputs_sha256(*w) != str(gold["inputs_sha256"]):
        raise AssertionError("the assembly golden workload rebuilt here "
                             "differs from the one the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns(dev), *w)
    wall = time.perf_counter() - t0
    bad, reach = mg.differing(out, gold), mg.check_reach(out)
    r_err = float(np.abs(out["rnaexpr:r"] - gold["rnaexpr:r"]).max())
    print(f"assembly golden ({wall} s; {len(mg.RUNS)} CLI runs: "
          f"{', '.join(mg.RUNS)}; filter_assemble, merge_pe_to_se, one "
          f"_overlap_pass batch): {len(out)} arrays compared, rnaexpr r "
          f"within {r_err} of JAX's (tolerance {mg.R_TOL}), differing: "
          f"{bad or 'none'}")
    if bad or reach:
        raise AssertionError(f"config #5 differs from the JAX golden in "
                             f"{bad}; reach {reach}")


def config5_full(torch, dev, card, tmp: Path):
    """Phase 14b: BASELINE config #5 at BASELINE.md's size through the
    port's CLI (filter, assemb, index + kalign, pescaffold, scaffold) and
    the fused filter_assemble, each output's SHA-256 against the JAX
    package's full run recorded in the golden."""
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.tools import make_assembly_golden as mg
    gold = np.load(mg.GOLDEN)
    steps = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    digests, seq = mg.full_run(mg.port_fns(dev), tmp,
                               lambda name: _cli_step(steps, name))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, v in digests.items() if str(v) != str(gold[k])]
    genome = dna.decode(seq)
    genome_rc = dna.decode(dna.revcomp(seq))
    pairs = int(mg.FULL_KBP * 1000 * mg.FULL_COV / 300)
    filt_log = steps["filter"][1]
    multi = {f: _multi_contig(tmp / f) for f in ("pescaffolds.fa",
                                                 "scaffolds.fa")}
    print(f"config #5 ({mg.FULL_KBP} kbp at {mg.FULL_COV}x: {pairs} pairs "
          f"of 2 x 150 + {pairs // 10} duplicated) through the CLI on "
          f"{card}: {wall} s; by step (wall s, PhaseTimer split): "
          + "; ".join(f"{k} {v[0]} {v[1].seconds}" for k, v in steps.items())
          + f"; filter removed {filt_log.removed}; CLI assemb contigs "
          f"{_contig_stats(tmp / 'contigs.fa', genome, genome_rc)}; fused "
          f"filter_assemble contigs "
          f"{_contig_stats(tmp / 'fused.fa', genome, genome_rc)}; "
          f"multi-contig scaffolds {multi}; peak device memory {peak} "
          f"bytes; outputs differing from the JAX package's full run: "
          f"{bad or 'none'}")
    if bad or not all(multi.values()):
        raise AssertionError(f"config #5 differs from the JAX package in "
                             f"{bad}, or joins no contigs: {multi}")


def neardup_full(torch, dev, card, tmp: Path):
    """Phase 14c: `filter -D 2` on phase 14b's reads under torch.profiler,
    then one `_overlap_pass` on 8,192 queries of its corpus, timed and
    held to the same pass on the CPU."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.assembly import filter as filt
    from kit4b_tpu_torch.assembly.overlap import (INT32_MAX, _overlap_pass,
                                                  corpus_genome)
    from kit4b_tpu_torch.assembly.store import SeqStore
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    from kit4b_tpu_torch.io.fasta import read_seqs
    from kit4b_tpu_torch.ops.extend_packed import pack_genome
    from kit4b_tpu_torch.ops.seed_extend_fast import make_gview_device
    r1, r2 = tmp / "r1.fa", tmp / "r2.fa"
    steps, rc = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _cli_step(steps, "filter -D 2"):
        wall, busy, n_ops = _profiled(torch, lambda: rc.append(cli.main(
            ["filter", "-i", str(r1), "-u", str(r2), "-o",
             str(tmp / "filt_D.fa"), "-D", "2"])))
    if rc != [0]:
        raise AssertionError(f"CLI filter -D 2 exited {rc}")
    log = steps["filter -D 2"][1]
    n_out = sum(1 for ln in open(tmp / "filt_D.fa") if ln.startswith(">"))
    n_in = sum(1 for ln in open(tmp / "filt.fa") if ln.startswith(">"))
    print(f"CLI filter -D 2 on {card}: wall {wall} s, phases {log.seconds};"
          f" removed {log.removed}; {n_out} reads kept ({n_in} without "
          f"-D); "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured, ")
          + f"{n_ops} device operations; peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    if not log.removed.get("near-duplicates") or n_out >= n_in:
        raise AssertionError(f"filter -D 2 removed no near-duplicate: "
                             f"{log.removed}")
    # one pass on 8,192 queries of the corpus mark_near_duplicates builds
    store = SeqStore.from_records(list(read_seqs(r1)), list(read_seqs(r2)))
    filt.mark_duplicates(store, pe=True)
    g, _ = corpus_genome(store.compact(), with_rc=False)
    idx = SfxIndex.build(g)
    win = int(g.lengths.max())
    nw2 = (win + 15) // 16 + 1
    gpack, gbad = pack_genome(g.seq, nw2 + 1)
    host = [g.seq, idx.sa_clean.astype(np.int32), idx.lut.astype(np.int32),
            g.starts.astype(np.int32),
            (g.starts + g.lengths).astype(np.int32),
            g.starts[:OVL_BATCH], g.lengths[:OVL_BATCH]]

    def pass_on(d):
        gview = make_gview_device(gpack, gbad, nw2, d)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(d)
                for x in host]
        return lambda: _overlap_pass(gview, *args, lut_k=idx.lut_k,
                                     cand=32, win=win)
    run = pass_on(dev)
    pos, mm = (x.cpu().numpy() for x in run())
    cpos, cmm = (x.numpy() for x in pass_on(torch.device("cpu"))())
    same = np.array_equal(pos, cpos) and np.array_equal(mm, cmm)
    ms = sorted(_time_ms(torch, run) for _ in range(5))
    pwall, pbusy, pops = _profiled(torch, run)
    print(f"_overlap_pass on {OVL_BATCH} queries (cand 32, win {win}) of "
          f"the {len(g.names)}-read corpus on {card}: median {ms[2]} ms of 5"
          f" (CUDA events: {ms}); {pops} device operations, device busy "
          f"{pbusy} s of {pwall} s; {int((pos != INT32_MAX).sum())} valid "
          f"candidates; equal to the CPU pass: {same}")
    if not same:
        raise AssertionError("_overlap_pass differs between card and CPU")


def _write_matrix_csv(path: Path, head: str, cols: list, rows: list,
                      values: np.ndarray) -> None:
    """A CSV of one header line and a named row per row of values, each
    value as Python writes it (floats round-trip)."""
    with open(path, "w") as f:
        f.write(head + "," + ",".join(cols) + "\n")
        for name, row in zip(rows, values.tolist()):
            f.write(name + "," + ",".join(map(str, row)) + "\n")


def float_full(torch, dev, card, tmp: Path):
    """Phase 14d: rnaexpr on 96 samples x 30,000 genes in replicate pairs
    with three pairs of labels swapped, and sarscov2ml on 10,000 isolates x
    400 features with planted linked groups, through the CLI on the card,
    against numpy in float64."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import rnaexpr
    rng = np.random.default_rng(SEED + 16)
    F, S = RNA_GENES, RNA_SAMPLES
    base = rng.gamma(2.0, 50.0, size=(F, S // 2))
    counts = np.round(np.repeat(base, 2, axis=1) * np.exp(rng.normal(
        0, 0.1, size=(F, S))), 1)
    names = [f"s{i:02d}" for i in range(S)]
    for a, b in RNA_SWAPS:
        names[a], names[b] = names[b], names[a]
    _write_matrix_csv(tmp / "counts.csv", "Feature",
                      [f'"{n}"' for n in names],
                      [f'"g{i}"' for i in range(F)], counts)
    (tmp / "part.csv").write_text("".join(f"s{i:02d},s{i ^ 1:02d}\n"
                                          for i in range(S)))
    t0 = time.perf_counter()
    if cli.main(["rnaexpr", "-i", str(tmp / "counts.csv"), "-c",
                 str(tmp / "part.csv"), "-o", str(tmp / "rna.csv")]) != 0:
        raise AssertionError("CLI rnaexpr exited non-zero")
    rna_wall = time.perf_counter() - t0
    ref = np.corrcoef(counts.T)                     # float64
    r = rnaexpr.pearson_matrix(counts, dev)
    r_err = float(np.abs(r - ref).max())
    col = {n: i for i, n in enumerate(names)}
    rows = [ln.split(",") for ln in open(tmp / "rna.csv").read()
            .splitlines()[1:]]
    csv_err = max(max(abs(float(x[2]) - ref[col[x[0].strip('"')],
                                           col[x[1].strip('"')]]),
                      abs(float(x[4]) - ref[col[x[0].strip('"')],
                                           col[x[3].strip('"')]]))
                  for x in rows)
    found = {x[0].strip('"') for x in rows if x[7] == "0"}
    planted = {n for i, n in enumerate(names)
               if col[f"s{int(n[1:]) ^ 1:02d}"] != i ^ 1}
    print(f"CLI rnaexpr on {S} samples x {F} genes on {card}: wall "
          f"{rna_wall} s; r against numpy float64: max error {r_err} "
          f"(pearson_matrix), {csv_err} (the CSV's 6-decimal fields); "
          f"{len(found)} inconsistent samples found, {len(planted)} planted,"
          f" equal: {found == planted}")
    if r_err > 1e-5 or csv_err > 1e-5 + 1e-6 or found != planted:
        raise AssertionError("rnaexpr: r off numpy's or the planted "
                             "inconsistencies not found")
    # sarscov2ml: background classes 0-3 (3 in 5 % of cells)
    m = rng.choice(4, size=(ML_ROWS, ML_FEATS), p=[0.4, 0.3, 0.25, 0.05])
    groups = []
    for n_feat, n_rows in ML_GROUPS:
        cols = sorted(rng.choice(ML_FEATS, n_feat, replace=False).tolist())
        rws = rng.choice(ML_ROWS, n_rows, replace=False)
        m[np.ix_(rws, cols)] = rng.integers(3, 6, size=(n_rows, n_feat))
        groups.append((cols, n_rows))
    feats = [f"F{i:03d}" for i in range(ML_FEATS)]
    _write_matrix_csv(tmp / "m.csv", "Isolate", feats,
                      [f"iso{i}" for i in range(ML_ROWS)], m)
    t0 = time.perf_counter()
    if cli.main(["sarscov2ml", "-i", str(tmp / "m.csv"), "-o",
                 str(tmp / "links.csv")]) != 0:
        raise AssertionError("CLI sarscov2ml exited non-zero")
    ml_wall = time.perf_counter() - t0
    hot = (m >= 3).astype(np.float32)
    co = (torch.from_numpy(hot).to(dev).T @ torch.from_numpy(hot).to(dev)
          ).cpu().numpy().astype(np.int64)
    co_exact = np.array_equal(co, hot.astype(np.int64).T
                              @ hot.astype(np.int64))
    links = [(int(ln.split(",", 1)[0]),
              set(ln.split(",", 1)[1].strip().strip('"').split(";")))
             for ln in open(tmp / "links.csv").read().splitlines()[1:]]
    hit = [any(rows >= n and {feats[c] for c in cols} == fs
               for rows, fs in links) for cols, n in groups]
    print(f"CLI sarscov2ml on {ML_ROWS} isolates x {ML_FEATS} features on "
          f"{card}: wall {ml_wall} s; {len(links)} linkages; planted groups "
          f"found {hit}; the float32 co-support on the card equals numpy's "
          f"int64 counts: {co_exact}")
    if not (co_exact and all(hit)):
        raise AssertionError("sarscov2ml: co-support inexact or a planted "
                             "group not found")


# --- phase 15: the PacBio long-read path --------------------------------

# the least time of the banded Smith-Waterman scan is set by its integer
# operations: each cell costs these int32 operations of the recurrence
# (kit4b_tpu_torch/kernels/sw.py's spec; a work-efficient max scan costs
# one max a cell), against one pointer byte written a cell
SW_CELL_OPS = (
    ("the target column, its two bounds and the code test", 4),
    ("the cell rule's two ANDs, the probe-target compare, the two selects "
     "of sub", 5),
    ("E: two adds, a max, the eext compare", 4),
    ("H0: an add, two maxes", 3),
    ("dirb: two compares, two selects", 4),
    ("X: an add of the column's constant", 1),
    ("F: the max scan's max, an add, the fext and usedf compares", 4),
    ("H = max(H0, F)", 1),
    ("the pointer byte: three shifts, three ORs", 6),
    ("the row peak: a compare, two selects", 3))
SW_OPS_PER_CELL = sum(n for _, n in SW_CELL_OPS)      # 35
INT32_RATE = 132 * 64 * 1.98e9   # H100 SXM: SMs x INT32 lanes x boost clock
SW_SHAPES = ("ecreads", "pbassemb", "pbfilter")   # tools/time_sw.py's
PB_KBP, PB_COV = 100.0, 8.0      # tools/pacbio_scale.py's measured size
PB_HAIRPIN_EVERY = 10            # one read in ten folded into a hairpin
PB_EC_ARGS = ("-l", "10000", "-L", "5000", "-b", "3000")
PB_OUTPUTS = ("filt.fa", "ec.fa", "contigs.fa", "polished.fa")
# 15c's outputs as the kernels of commit 6e8cd91 (one block a pair, one
# thread a pair) wrote them: that commit's package driven by this file's
# pacbio_full (NVIDIA H100 80GB HBM3, 700.00 W)
PB_SHA256 = {
    "filt.fa":
        "e419023023a65d0e0e50b41e9e86215df03ecf445b0e10d9123e7fc04cd16cdb",
    "ec.fa":
        "7cf4382c7128894bc557b8147a79ceb7705886e52414182597c261170f076c76",
    "contigs.fa":
        "b2727d9b324b80c51275751a5eb3ec4beddf224b0103a3cc2a85595cc24c8189",
    "polished.fa":
        "e7ac47795f5f52bad350ddd3266ab0995fdef4e916d3502274d2cf381c993587"}


def pacbio_golden(torch, dev):
    """Phase 15a: the banded SW engine's edge cases and the four PacBio
    functions through the port on the card against the JAX package's
    golden."""
    from kit4b_tpu_torch.tools import make_pacbio_golden as mg
    gold = np.load(mg.GOLDEN)
    cases, work = mg.sw_cases(), mg.workload()
    if mg.inputs_sha256(cases, work) != str(gold["inputs_sha256"]):
        raise AssertionError("the PacBio golden inputs rebuilt here differ "
                             "from the ones the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns(dev), cases, work)
    wall = time.perf_counter() - t0
    bad, reach = mg.differing(out, gold), mg.check_reach(out)
    print(f"PacBio golden ({wall} s; {len(cases)} engine cases, "
          f"correct_reads, filter_reads, assemble, polish_contigs): "
          f"{len(out)} arrays compared, differing: {bad or 'none'}")
    if bad or reach:
        raise AssertionError(f"the PacBio path differs from the JAX golden "
                             f"in {bad}; reach {reach}")


def sw_scan_bound_ms(B, Lp, Lt, W) -> tuple[float, str]:
    """(ms, what sets it) of one scan: its int32 operations over the card's
    int32 rate, or its bytes (codes read once, pointer bytes written once)
    over the memory rate."""
    ops = B * Lp * W * SW_OPS_PER_CELL / INT32_RATE
    nbytes = (B * Lp + B * Lt + 24 * B + B * Lp * W) / HBM_RATE
    return max(ops, nbytes) * 1e3, ("operations" if ops >= nbytes
                                    else "bytes")


def sw_traceback_bound_ms(n, nm, nmm, L_OPS) -> float:
    """ms of one traceback's bytes over the memory rate: a pointer byte for
    each cell the walk visits (n + 1), the two codes of each M op, the op
    codes written (B x L_OPS) and 36 bytes of scalars a lane."""
    B = len(n)
    nbytes = (int(n.sum()) + B + 2 * int(nm.sum() + nmm.sum()) + B * L_OPS
              + 36 * B)
    return nbytes / HBM_RATE * 1e3


def sw_cell_instructions(lib: Path) -> dict:
    """SASS instructions of the scan kernel's row loop (the longest
    backward branch of each cluster instantiation with no EXIT inside it),
    by `cuobjdump -sass` of the built library: {C: instructions} and, under
    "cell", the instructions a cell, (loop at C 8 - loop at C 4) / 4,
    which leaves out the row's fixed work (shuffles, the exchange)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    loops = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*sw_scan_kernelILi(\d)ELb1EE", part)
        if not m:      # the cluster instantiations
            continue
        addr = [(int(a, 16), ins) for a, ins in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        at = {a: n for n, (a, _) in enumerate(addr)}
        spans = [n - at[int(t, 16)] + 1 for n, (a, ins) in enumerate(addr)
                 for t in re.findall(r"\bBRA\b[^;]*?0x([0-9a-f]+)", ins)
                 if int(t, 16) in at and int(t, 16) < a and not any(
                     "EXIT" in x for _, x in addr[at[int(t, 16)]:n])]
        loops[int(m.group(1))] = max(spans, default=0)
    loops["cell"] = (loops[8] - loops[4]) / 4 if 4 in loops and 8 in loops \
        else None
    return loops


def sw_vs_plain(torch, dev, batch, label, timed=False, traceback=True):
    """Both kernels against their plain versions on one batch as
    banded_sw_batch takes it: (probes, plens, targets, tlens, diag0, W,
    (match, mismatch, open, ext)); or the traceback alone on a dict of
    `sw_cluster_cases.random_pointer_cases`. Raises unless the pointer
    arrays and every output are equal, the walks also cut at L_OPS 37; with
    `timed`, returns the kernels' times (CUDA events, median of 5), the
    plain versions' (the one run compared), the walks and the shape."""
    from kit4b_tpu_torch.kernels import sw
    from kit4b_tpu_torch.tools.time_sw import on_card
    names = ("ops", "n", "ps", "ts", "nm", "nmm")
    if isinstance(batch, dict):
        c = batch
        t = [torch.from_numpy(c[k]).to(dev) for k in (
            "ptrs", "probes", "targets", "best", "bi", "bk", "diag0")]
        kw = dict(W=c["W"], L_OPS=c["L_OPS"])
        bad = [k for k, g, w in zip(names, sw.sw_traceback(*t, **kw),
                                    sw.traceback_plain(*t, **kw))
               if not torch.equal(g, w)]
        if bad:
            raise AssertionError(f"sw_traceback differs from its plain "
                                 f"version in {bad}: {label}")
        print(f"sw_traceback vs plain [{label}]: walks equal")
        return None
    (p, t, pl, tl, d0), kw = on_card(torch, batch, dev)
    W = kw["W"]
    B, Lp = p.shape
    L_OPS = Lp + W
    layout = sw.scan_layout(B, W, torch.cuda.get_device_properties(
        dev).multi_processor_count)

    def scan():
        return sw.sw_scan(p, t, pl, tl, d0, traceback=traceback, **kw)
    got = scan()
    want, scan_plain_ms = _with_ms(torch, lambda: sw.sw_scan_plain(
        p, t, pl, tl, d0, traceback=traceback, **kw))
    bad = [k for k, g, w in zip(("best", "bi", "bk", "pointer bytes"), got,
                                want)
           if not (g is None and w is None or torch.equal(g, w))]
    if bad:
        raise AssertionError(f"sw_scan differs from its plain version in "
                             f"{bad}: {label}")
    if not traceback:
        print(f"sw_scan vs plain [{label}]: B={B} Lp={Lp} W={W} layout "
              f"{layout}, traceback=False: best cells equal")
        return None
    best, bi, bk, ptrs = got
    del want

    def trace(lim=L_OPS):
        return sw.sw_traceback(ptrs, p, t, best, bi, bk, d0, W=W, L_OPS=lim)
    tgot = trace()
    for lim in (L_OPS, 37):
        twant, ms = _with_ms(torch, lambda: sw.traceback_plain(
            ptrs, p, t, best, bi, bk, d0, W=W, L_OPS=lim))
        bad = [k for k, g, w in zip(names, tgot if lim == L_OPS
                                    else trace(lim), twant)
               if not torch.equal(g, w)]
        if bad:
            raise AssertionError(f"sw_traceback differs from its plain "
                                 f"version in {bad}: {label}, L_OPS {lim}")
        if lim == L_OPS:
            tb_plain_ms = ms
    n, nm, nmm = (x.cpu().numpy() for x in (tgot[1], tgot[4], tgot[5]))
    print(f"sw kernels vs plain [{label}]: B={B} Lp={Lp} Lt={t.shape[1]} "
          f"W={W} layout {layout}: pointer bytes, best cells and walks "
          f"equal (walk ops {int(n.sum())}, longest {int(n.max())})")
    if not timed:
        return None
    scan_ms = sorted(_time_ms(torch, scan) for _ in range(5))
    tb_ms = sorted(_time_ms(torch, trace) for _ in range(5))
    return dict(B=B, Lp=Lp, Lt=t.shape[1], W=W, L_OPS=L_OPS, layout=layout,
                scan_ms=scan_ms[2], scan_runs=scan_ms,
                scan_plain_ms=scan_plain_ms, tb_ms=tb_ms[2], tb_runs=tb_ms,
                tb_plain_ms=tb_plain_ms, n=n, nm=nm, nmm=nmm)


def sw_plain_ops(torch, dev, case):
    """Device operations of the plain scan and traceback on one of the
    golden's cases, by torch.profiler (a small case: the profiler's own
    cost grows with the operations it records). Returns (scan operations,
    traceback operations, the longest walk)."""
    from kit4b_tpu_torch.kernels import sw
    from kit4b_tpu_torch.tools import make_pacbio_golden as mg
    pp, tp = mg.padded(case)
    p, t, pl, tl, d0 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (pp, tp, case["plens"], case["tlens"],
                                  case["diag0"]))
    m, mm, go, ge = case["scores"]
    W = case["band"]
    out = []
    _, _, scan_ops = _profiled(torch, lambda: out.extend(sw.sw_scan_plain(
        p, t, pl, tl, d0, W=W, match=m, mismatch=mm, gap_open=go,
        gap_ext=ge)))
    best, bi, bk, ptrs = out
    res = []
    _, _, tb_ops = _profiled(torch, lambda: res.extend(sw.traceback_plain(
        ptrs, p, t, best, bi, bk, d0, W=W, L_OPS=pp.shape[1] + W)))
    return scan_ops, tb_ops, int(res[1].max())


def sw_kernels(torch, dev, card):
    """Phase 15b: the cluster's own costs; both kernels against their plain
    versions on the golden's edge cases, on the cases built to break the
    cluster scan and the tiled walk, on random pointer bytes and at the
    three caller shapes of tools/time_sw.py, which are then timed (CUDA
    events, median of 5) beside the plain versions and the bounds. Returns
    15b's batch's times and bounds (the kernels line)."""
    from kit4b_tpu_torch.kernels import build, sw
    from kit4b_tpu_torch.tools import make_pacbio_golden as mg
    from kit4b_tpu_torch.tools import sw_cluster_cases as cc
    from kit4b_tpu_torch.tools import time_sw
    smem_ns = None
    for P in (2, 4, 8):
        bar, dsmem, smem_ns = sw.cluster_costs(dev, P)
        print(f"cluster of {P} blocks on {card}: a barrier (arrive + wait) "
              f"{bar} ns, a DSMEM load {dsmem} ns, a shared-memory load "
              f"{smem_ns} ns (20,000 of each, %globaltimer)")
    for c in mg.sw_cases() + cc.cluster_cases():
        sw_vs_plain(torch, dev, (
            c["probes"], c["plens"], c["targets"], c["tlens"], c["diag0"],
            c["band"], c["scores"]), c["label"], traceback=c["traceback"])
    for c in cc.random_pointer_cases():
        sw_vs_plain(torch, dev, c, c["label"])
    loops = sw_cell_instructions(build.paths("sw")[1])
    cell = loops["cell"]
    print(f"sw_scan's row loop in SASS (instructions by columns a thread): "
          f"{ {k: v for k, v in loops.items() if k != 'cell'} }; "
          f"{cell} instructions a cell")
    rng = np.random.default_rng(time_sw.SEED)
    out = {}
    for name in SW_SHAPES:
        t = sw_vs_plain(torch, dev, time_sw.BATCHES[name](rng),
                        f"{name}'s shape", timed=True)
        B, Lp, W = t["B"], t["Lp"], t["W"]
        clusters = sw.scan_clusters(dev, B, W, t["layout"])
        s35, s_by = sw_scan_bound_ms(B, Lp, t["Lt"], W)
        sdpx = B * Lp * W * cell / INT32_RATE * 1e3 if cell else None
        bound = min(s35, sdpx) if sdpx else s35
        tb_bound = sw_traceback_bound_ms(t["n"], t["nm"], t["nmm"],
                                         t["L_OPS"])
        floor = (int(t["n"].max()) + 1) * smem_ns * 1e-6
        print(f"sw_scan at {name}'s shape (B={B} Lp={Lp} W={W}) on {card}: "
              f"layout (P, C) = {t['layout']}, {clusters} clusters at once; "
              f"kernel median {t['scan_ms']} ms of 5 (CUDA events: "
              f"{t['scan_runs']}), plain {t['scan_plain_ms']} ms; bound "
              f"{s35} ms ({s_by}: {SW_OPS_PER_CELL} int32 operations a "
              f"cell at {INT32_RATE / 1e12:g} T/s), {sdpx} ms at the "
              f"kernel's {cell} instructions a cell; kernel at "
              f"{bound / t['scan_ms']} of the smaller")
        print(f"sw_traceback at {name}'s shape on {card}: kernel median "
              f"{t['tb_ms']} ms of 5 (CUDA events: {t['tb_runs']}), plain "
              f"{t['tb_plain_ms']} ms; bound {tb_bound} ms (bytes), kernel "
              f"at {tb_bound / t['tb_ms']} of it; floor of a serial walk "
              f"{floor} ms (the longest walk's {int(t['n'].max())} steps "
              f"and its stop x a {smem_ns} ns shared-memory load)")
        out[name] = dict(t, scan_bound=bound, scan_by=s_by, tb_bound=tb_bound)
        torch.cuda.empty_cache()
    case = next(c for c in mg.sw_cases() if c["label"] == "oracle")
    scan_ops, tb_ops, walk = sw_plain_ops(torch, dev, case)
    print(f"plain versions' device operations (torch.profiler) on the "
          f"golden's oracle case (B 4, Lp 512, W 128): scan {scan_ops}, "
          f"traceback {tb_ops} (longest walk {walk} ops)")
    return out["ecreads"]


def _synced(torch, fn):
    def call(*a, **kw):
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out
    return call


def _pacbio_readset(tmp: Path):
    """tools/pacbio_scale.py's readset (tools.pacbio_reads, seed 99) with
    one read in PB_HAIRPIN_EVERY folded on its reverse complement, as
    FASTA; returns (genome, the reads before folding, truth windows by
    read name, the names of the folded reads)."""
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
    from kit4b_tpu_torch.tools import pacbio_reads
    genome, reads, truth = pacbio_reads.simulate(PB_KBP, PB_COV)
    out, hairpins = [], []
    for i, r in enumerate(reads):
        codes = r.codes
        if i % PB_HAIRPIN_EVERY == 0:
            codes = np.concatenate([codes, dna.revcomp(codes)])
            hairpins.append(r.name)
        out.append(SeqRecord(r.name, "", codes))
    write_fasta(tmp / "raw.fa", out)
    lens = [len(r.codes) for r in reads]
    print(f"PacBio readset (tools/pacbio_scale.py, seed 99): {len(reads)} "
          f"reads of {min(lens)}-{max(lens)} bp, {sum(lens)} bp "
          f"({PB_COV}x of {PB_KBP} kbp), {len(hairpins)} folded into "
          f"hairpins")
    return genome, reads, dict(zip((r.name for r in reads), truth)), \
        hairpins


def _identity(genome, truth, records, dev):
    """Median SW identity (tools/pacbio_scale.py's) of each record against
    the truth window of the read it came from: its name holds the read's
    `pb<i>|<start>|<span>`, and a hairpin's second subread (`/sub2`) is
    that read reverse-complemented."""
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.tools.pacbio_reads import identity_vs_truth
    ids = []
    for r in records:
        parts = r.name.split("|")
        j = next(j for j, p in enumerate(parts) if p.startswith("pb"))
        span, _, sub = parts[j + 2].partition("/")
        codes = np.asarray(r.codes, np.uint8)
        if sub == "sub2":
            codes = dna.revcomp(codes)
        ids.append(identity_vs_truth(
            codes, genome, *truth[f"{parts[j]}|{parts[j + 1]}|{span}"],
            device=dev))
    return float(np.median(ids)) if ids else 0.0, len(ids)


def pacbio_full(torch, dev, card, tmp: Path):
    """Phase 15c: tools/pacbio_scale.py's readset (100 kbp at 8x, seed 99,
    one read in ten a hairpin) through the CLI `pbfilter`, `ecreads -l
    10000 -L 5000 -b 3000`, `pbassemb` and `eccontigs`, each step's wall
    split by function, its SW batches, kernel launches, device busy share
    and peak memory; the corrected reads' identity to the truth against
    the raw reads'; ecreads' first and longest SW batches held to the
    plain versions. Returns the kernels' launches over the four steps and
    the SHA-256 of the four outputs by file name."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.io.fasta import read_seqs
    from kit4b_tpu_torch.kernels import sw
    from kit4b_tpu_torch.pacbio import consensus, ecreads, pbassemb, \
        pbfilter, sswd
    from kit4b_tpu_torch.tools.time_sw import held_batches
    genome, reads, truth, hairpins = _pacbio_readset(tmp)

    def hold(mod, probes, held):
        """ecreads' first batch and its longest (the first of that width)."""
        if mod is not ecreads or held and \
                probes.shape[1] <= held[-1][0].shape[1]:
            return False
        del held[1:]
        return True
    f = tmp
    steps = [("pbfilter", ["pbfilter", "-i", f"{f}/raw.fa", "-o",
                           f"{f}/filt.fa"]),
             ("ecreads", ["ecreads", "-i", f"{f}/filt.fa", "-o",
                          f"{f}/ec.fa", *PB_EC_ARGS]),
             ("pbassemb", ["pbassemb", "-i", f"{f}/ec.fa", "-o",
                           f"{f}/contigs.fa"]),
             ("eccontigs", ["eccontigs", "-i", f"{f}/contigs.fa", "-r",
                            f"{f}/ec.fa", "-o", f"{f}/polished.fa"])]
    split = [("index build", ecreads, "build_read_index"),
             ("index build", pbassemb, "build_read_index"),
             ("candidates", ecreads, "_candidates"),
             ("candidates", pbassemb, "_candidates"),
             ("hairpin seeds", pbfilter, "_self_rc_diag"),
             ("SW scan", sswd, "sw_scan"),
             ("traceback", sswd, "sw_traceback"),
             ("consensus", consensus.ConsensusBuilder, "add"),
             ("consensus", consensus.ConsensusBuilder, "call")]
    saved = [(sswd, n, getattr(sswd, n)) for n in (
        "sw_scan", "sw_traceback")]
    sswd.sw_scan = _synced(torch, sw.sw_scan)
    sswd.sw_traceback = _synced(torch, sw.sw_traceback)
    launches = {"sw_scan": 0, "sw_traceback": 0}
    try:
        with held_batches(ecreads, pbfilter, pbassemb, hold=hold) as held:
            for name, argv in steps:
                rc = []
                held.calls = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                with _timed(split) as secs:
                    wall, busy, n_ops = _profiled(
                        torch, lambda: rc.append(cli.main(argv)))
                n_scan = sw.sw_scan.launches
                n_tb = sw.sw_traceback.launches
                peak = torch.cuda.max_memory_allocated()
                if rc != [0]:
                    raise AssertionError(f"CLI {name} exited {rc}")
                out = argv[argv.index("-o") + 1]
                n_out = sum(1 for _ in read_seqs(out))
                print(f"CLI {name} on {card}: wall {wall} s, split (s) "
                      f"{ {k: v for k, v in secs.items() if v} }; "
                      f"{held.calls} SW batches, kernel launches sw_scan "
                      f"{n_scan} sw_traceback {n_tb}; "
                      + (f"device busy {busy} s ({busy / wall} of the "
                         f"wall), " if busy else "device busy not measured, ")
                      + f"{n_ops} device operations; peak device memory "
                      f"{peak} bytes; {n_out} records out")
                if not (n_scan == n_tb == held.calls > 0):
                    raise AssertionError(
                        f"{name}: {held.calls} SW batches but {n_scan} scan "
                        f"and {n_tb} traceback launches")
                launches["sw_scan"] += n_scan
                launches["sw_traceback"] += n_tb
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    filt = list(read_seqs(tmp / "filt.fa"))
    split_names = {r.name.split("/")[0] for r in filt if "/sub" in r.name}
    ec = list(read_seqs(tmp / "ec.fa"))
    long_in = sum(len(r.codes) >= 10_000 for r in filt)
    # the tool's raw baseline: every len // 12-th read
    raw_id, n_raw = _identity(genome, truth,
                              reads[::max(1, len(reads) // 12)], dev)
    cor_id, n_cor = _identity(genome, truth, ec, dev)
    ctg = [len(r.codes) for r in read_seqs(tmp / "contigs.fa")]
    pol = [len(r.codes) for r in read_seqs(tmp / "polished.fa")]
    print(f"PacBio path on {card}: pbfilter split {len(split_names)} reads "
          f"({len(hairpins)} hairpins planted, "
          f"{len(set(hairpins) - split_names)} of them not split); ecreads corrected {len(ec)} of "
          f"{long_in} reads of >= 10 kbp; SW identity to the truth, median: "
          f"raw {raw_id} ({n_raw} reads), corrected {cor_id} ({n_cor} "
          f"reads); pbassemb {len(ctg)} contigs, longest "
          f"{max(ctg, default=0)}, total {sum(ctg)}; eccontigs "
          f"{len(pol)} polished, total {sum(pol)}")
    for label, batch in (("first", held[0]), ("longest", held[-1])):
        sw_vs_plain(torch, dev, batch, f"ecreads' {label} batch")
    torch.cuda.empty_cache()
    sha = {n: hashlib.sha256((tmp / n).read_bytes()).hexdigest()
           for n in PB_OUTPUTS}
    print(f"PacBio path outputs, SHA-256: {json.dumps(sha)}")
    if set(hairpins) - split_names or len(ec) < 0.8 * long_in \
            or cor_id < raw_id + 0.1 or not ctg:
        raise AssertionError(
            f"PacBio path: {sorted(set(hairpins) - split_names)} hairpins "
            f"not split, "
            f"{len(ec)} of {long_in} reads corrected, identity {raw_id} -> "
            f"{cor_id}, {len(ctg)} contigs")
    return launches, sha


# blitz, hrdx, kmerdist and the scorer group (phase 16)
BLITZ_QUERIES, BLITZ_RANDOM = 1_000, 50     # planted and random queries
BLITZ_LENS = (1_000, 16_000)
HRDX_HAP, HRDX_CTG = 2_000_000, (5_000, 60_000)   # a haplotype, contigs
HRDX_UNIQUE, HRDX_UNIQUE_LEN = 20, 10_000
BENCH_PROFILES = 20_000     # benchmark -m 1/-m 2: profiles, replayed reads
RNADE_READS, RNADE_GENES = 50_000, 200
SBS_ASM, SBS_QUERIES, SBS_TARGETS, SBS_BOOT = 100_000, 2_000, 200, 10
MAPLOCI_FEATURES = 500


def longtail_golden(torch, dev):
    """Phase 16a: blitz (the small and big sets, gapped and not), hrdx,
    kmerdist, benchmark modes 0-4, alignsbs, ngsqc, maploci and rnade
    through the port's CLI on the card against the JAX package's golden,
    every file byte for byte."""
    from kit4b_tpu_torch.tools import make_longtail_golden as mg
    gold = np.load(mg.GOLDEN)
    work = mg.workload()
    if mg.inputs_sha256(work) != str(gold["inputs_sha256"]):
        raise AssertionError("the long-tail golden inputs rebuilt here "
                             "differ from the ones the golden was made from")
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns(dev), work, big=True)
    wall = time.perf_counter() - t0
    bad, reach = mg.differing(out, gold), mg.check_reach(out)
    print(f"long-tail golden ({wall} s; blitz small and big sets gapped and "
          f"ungapped, hrdx, kmerdist, benchmark 0-4, alignsbs, ngsqc, "
          f"maploci, rnade): {len(out)} arrays compared, differing: "
          f"{bad or 'none'}")
    if bad or reach:
        raise AssertionError(f"the long-tail commands differ from the JAX "
                             f"golden in {bad}; reach {reach}")


def _psl_checks(rows, queries, genome):
    """16b's checks on a gapped PSL: every planted query's best hit (its
    first row) on its strand, within 50 bp of its truth start, spanning at
    least 90 % of the query, and carrying its InDel to the base: target
    gap bases less the deletion equal query gap bases less the insertion,
    and are at most 2. Such extra bases come in pairs, a base of each
    around a run of three mismatches, where SWScores(1, -2, -3, -1) scores
    two 1-base gaps and the two matches they bring (-4) above the
    mismatches (-6). No row for a random query; every row's blocks,
    compared base by base with the genome, giving exactly its matches and
    mismatches. Returns the faults and the names of the best hits with
    extra gap bases."""
    best, faults, extra = {}, [], []
    for r in rows:
        best.setdefault(r[9], r)
        q = queries[r[9]]
        if r[8] == "-":
            q = _revcomp(q)
        eq = [q[qb:qb + n] == genome[tb:tb + n] for qb, tb, n in zip(*(
            [int(x) for x in r[c].rstrip(",").split(",")]
            for c in (19, 20, 18)))]
        eq = np.concatenate(eq)
        if (int(eq.sum()), int((~eq).sum())) != (int(r[0]), int(r[1])):
            faults.append(f"{r[9]}: blocks give {int(eq.sum())} matches, "
                          f"{int((~eq).sum())} mismatches, PSL {r[0]}, "
                          f"{r[1]}")
    for name, codes in queries.items():
        if name.startswith("r"):
            if name in best:
                faults.append(f"{name}: a random query hit")
            continue
        _, _, start, _, strand, d, ins = name.split("|")
        r = best.get(name)
        if r is None:
            faults.append(f"{name}: no hit")
            continue
        more_t, more_q = int(r[7]) - int(d), int(r[5]) - int(ins)
        if more_t or more_q:
            extra.append(name)
        if r[8] != strand or abs(int(r[15]) - int(start)) > 50 \
                or int(r[12]) - int(r[11]) < 0.9 * len(codes) \
                or more_t != more_q or not 0 <= more_t <= 2:
            faults.append(f"{name}: best hit {r[8]} {r[15]}-{r[16]}, query "
                          f"{r[11]}-{r[12]} of {len(codes)}, gap bases "
                          f"query {r[5]}, target {r[7]}")
    return faults, extra


def blitz_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phase 16b: on config #1's genome (4.6 Mbp, default_rng(12345)) and
    8b's index of it, BLITZ_QUERIES planted queries of 1-16 kbp and
    BLITZ_RANDOM random ones of 2 kbp through the CLI `blitz` (gapped: one
    SW batch a query) and `blitz --no-gapped`; the gapped run's wall split
    into seeding, chaining, the SW scan and traceback, the rest of the SW
    batches (uploads, the run-length collapse), the block walk and the PSL
    write, with its SW launches, device busy share and peak memory; the
    PSL checked by `_psl_checks`; the longest query's batch and the median
    query's held to the plain versions and timed beside their bounds.
    Returns the SW launches of the gapped run, the genome and index paths,
    the genome's codes, the gapped PSL and the queries."""
    from kit4b_tpu_torch import cli
    from kit4b_tpu_torch.align import blitz
    from kit4b_tpu_torch.kernels import sw
    from kit4b_tpu_torch.pacbio import sswd
    from kit4b_tpu_torch.tools import make_longtail_golden as mg
    from kit4b_tpu_torch.tools.time_sw import held_batches
    codes = np.random.default_rng(12345).integers(0, 4, ECOLI_LEN) \
        .astype(np.uint8)
    fa, kix = config1_files(cfg1)
    queries = dict(mg.planted_queries(
        np.random.default_rng(SEED + 16), [("ecoli_sim", codes)],
        BLITZ_QUERIES, BLITZ_RANDOM, BLITZ_LENS))
    write_fasta(tmp / "queries.fa", list(queries), list(queries.values()))
    lens = [len(c) for c in queries.values()]
    print(f"blitz queries: {BLITZ_QUERIES} planted of {min(lens)}-"
          f"{max(lens)} bp (1 % substitutions, a 10-40 bp deletion in "
          f"half, an insertion in a quarter, half reverse-complemented) and "
          f"{BLITZ_RANDOM} random of 2 kbp, {sum(lens)} bp, on 8b's "
          f"index of config #1's genome")
    split = [("seeding", blitz, "_seed_hits"),
             ("chaining", blitz, "_chain_and_score"),
             ("refinement", blitz, "_refine_gapped"),
             ("SW batches", sswd, "banded_sw_batch"),
             ("SW scan", sswd, "sw_scan"),
             ("traceback", sswd, "sw_traceback"),
             ("PSL write", blitz, "write_psl")]
    saved = [(sswd, n, getattr(sswd, n)) for n in (
        "sw_scan", "sw_traceback")]
    sswd.sw_scan = _synced(torch, sw.sw_scan)
    sswd.sw_traceback = _synced(torch, sw.sw_traceback)
    psl = tmp / "blitz.psl"
    rc = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with held_batches(sswd) as held, \
                _timed(split, nested=True) as secs:
            wall, busy, n_ops = _profiled(torch, lambda: rc.append(cli.main(
                ["blitz", "-i", str(tmp / "queries.fa"), "-I", str(kix),
                 "-o", str(psl)])))
        launches = {"sw_scan": sw.sw_scan.launches,
                    "sw_traceback": sw.sw_traceback.launches}
        peak = torch.cuda.max_memory_allocated()
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    if rc != [0]:
        raise AssertionError(f"CLI blitz exited {rc}")
    walk = secs["refinement"] - secs["SW batches"]
    sw_host = secs["SW batches"] - secs["SW scan"] - secs["traceback"]
    print(f"CLI blitz (gapped) on {card}: wall {wall} s; seeding "
          f"{secs['seeding']} s, chaining {secs['chaining']} s, SW scan "
          f"{secs['SW scan']} s, traceback {secs['traceback']} s, the rest "
          f"of the SW batches (uploads, collapse) {sw_host} s, block walk "
          f"{walk} s, PSL write {secs['PSL write']} s; {len(held)} SW "
          f"batches, launches {launches}; "
          + (f"device busy {busy} s ({busy / wall} of the wall), "
             if busy else "device busy not measured, ")
          + f"{n_ops} device operations; peak device memory {peak} bytes")
    if not (launches["sw_scan"] == launches["sw_traceback"] == len(held)
            > 0):
        raise AssertionError(f"{len(held)} SW batches but {launches} "
                             f"launches")
    ung = tmp / "blitz_ungapped.psl"
    with _timed(split[:2]) as usecs:
        t0 = time.perf_counter()
        rc = cli.main(["blitz", "--no-gapped", "-i",
                       str(tmp / "queries.fa"), "-I", str(kix), "-o",
                       str(ung)])
        uwall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI blitz --no-gapped exited {rc}")
    text = psl.read_text()
    rows, urows = mg.psl_rows(text), mg.psl_rows(ung.read_text())
    faults, extra = _psl_checks(rows, queries, codes)
    n_indel = sum(1 for n in queries if n.startswith("p") and (
        n.split("|")[5] != "0" or n.split("|")[6] != "0"))
    print(f"CLI blitz --no-gapped on {card}: wall {uwall} s (seeding "
          f"{usecs['seeding']} s, chaining {usecs['chaining']} s), "
          f"{len(urows)} hits of {len({r[9] for r in urows})} queries; "
          f"gapped: {len(rows)} hits of {len({r[9] for r in rows})} "
          f"queries; every planted InDel carried to the base ({n_indel}); "
          f"best hits with a pair of extra gap bases: {extra or 'none'}; "
          f"faults: {faults[:10] or 'none'}")
    if faults:
        raise AssertionError(f"blitz: {len(faults)} faults, {faults[:10]}")
    by_len = sorted(held, key=lambda b: b[0].shape[1])
    for label, batch in (("the longest query's", by_len[-1]),
                         ("the median query's", by_len[len(by_len) // 2])):
        t = sw_vs_plain(torch, dev, batch, f"blitz, {label} batch",
                        timed=True)
        B, Lp, W = t["B"], t["Lp"], t["W"]
        s_bound, s_by = sw_scan_bound_ms(B, Lp, t["Lt"], W)
        tb_bound = sw_traceback_bound_ms(t["n"], t["nm"], t["nmm"],
                                         t["L_OPS"])
        print(f"blitz SW at {label} shape (B={B} Lp={Lp} Lt={t['Lt']} W={W}"
              f", layout {t['layout']}) on {card}: sw_scan median "
              f"{t['scan_ms']} ms of 5 (CUDA events: {t['scan_runs']}), "
              f"plain {t['scan_plain_ms']} ms, bound {s_bound} ms ({s_by}),"
              f" kernel at {s_bound / t['scan_ms']} of it; sw_traceback "
              f"median {t['tb_ms']} ms of 5 ({t['tb_runs']}), plain "
              f"{t['tb_plain_ms']} ms, bound {tb_bound} ms (bytes), kernel "
              f"at {tb_bound / t['tb_ms']} of it")
    del held, by_len
    torch.cuda.empty_cache()
    return launches, fa, kix, codes, text, queries


def _csv_rows(path: Path) -> list[list[str]]:
    return [r.split(",") for r in path.read_text().splitlines()[1:]]


def _cli_steps(card, steps, seconds=None):
    """Runs (label, argv) CLI steps in order, each timed (into `seconds`
    by label, where given); returns their standard output by label."""
    from kit4b_tpu_torch import cli
    printed = {}
    for label, argv in steps:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(a) for a in argv])
        s = time.perf_counter() - t0
        if seconds is not None:
            seconds[label] = s
        print(f"CLI {label} on {card}: {s} s")
        if rc != 0:
            raise AssertionError(f"CLI {label} exited {rc}")
        printed[label] = buf.getvalue()
    return printed


def longtail_full(torch, dev, card, tmp: Path, cfg1: Path, fa, kix, codes,
                  psl, queries):
    """Phase 16c: hrdx on two 2 Mbp haplotypes cut into contigs with 20
    unique ones (every unique kept, the kept length 0.9-1.3 x a
    haplotype); kmerdist on a MAF of 16b's gapped hits, equal to the runs
    counted from the hits; 8b's 100,000 reads of 100 bp and the mapped
    records of its SAM (what `kalign` with the default -M 0 writes of
    them) -> benchmark -m 4 (>= 99.9 % of aligned reads at their truth),
    then -m 1 -> -m 2 -> kalign -> -m 3 and -m 0; alignsbs (2,000 queries
    of 100-150 bp, 200 targets of 2 kbp, 10 bootstraps) on the card;
    ngsqc -H - on the reads; maploci against 500 BED features, equal to a
    direct count; rnade on two kalign SAMs against 200 genes."""
    from kit4b_tpu_torch.io.fasta import read_seqs
    from kit4b_tpu_torch.tools import make_longtail_golden as mg
    rng = np.random.default_rng(SEED + 17)
    ctgs = mg.diploid_contigs(rng, HRDX_HAP, HRDX_CTG, HRDX_UNIQUE,
                              HRDX_UNIQUE_LEN)
    write_fasta(tmp / "diploid.fa", [n for n, _ in ctgs],
                [c for _, c in ctgs])
    maf = tmp / "blitz.maf"
    maf.write_text(mg.maf_text(psl, {"ecoli_sim": codes}, queries))
    asm = codes[:SBS_ASM]
    write_fasta(tmp / "asm.fa", ["asm"], [asm])
    qs = [int(x) for x in rng.integers(100, 151, SBS_QUERIES)]
    q_at = rng.integers(0, SBS_ASM - 150, SBS_QUERIES)
    write_fasta(tmp / "sbs_q.fa", [f"q{i}" for i in range(SBS_QUERIES)],
                [asm[s:s + n] for s, n in zip(q_at, qs)])
    t_at = rng.integers(0, SBS_ASM - 2_000, SBS_TARGETS)
    write_fasta(tmp / "sbs_t.fa", [f"t{i}" for i in range(SBS_TARGETS)],
                [asm[s:s + 2_000] for s in t_at])
    f_at = np.sort(rng.integers(0, ECOLI_LEN - 2_000, MAPLOCI_FEATURES))
    f_len = rng.integers(100, 2_000, MAPLOCI_FEATURES)
    (tmp / "feats.bed").write_text("".join(
        f"ecoli_sim\t{s}\t{s + n}\tf{i}\t0\t{'+-'[i % 2]}\n"
        for i, (s, n) in enumerate(zip(f_at, f_len))))
    mg.genes_bed(tmp / "genes.bed", mg.random_genes(rng, RNADE_GENES,
                                                    ECOLI_LEN),
                 "ecoli_sim", bed6=None)
    t = tmp
    _, reads, sam_m1 = config1_reads(cfg1)
    with open(sam_m1) as src, open(t / "out.sam", "w") as dst:
        dst.writelines(ln for ln in src if ln.startswith("@")
                       or not int(ln.split("\t", 2)[1]) & 4)
    printed = _cli_steps(card, [
        ("hrdx", ["hrdx", "-i", t / "diploid.fa", "-o", t / "reduced.fa"]),
        ("kmerdist", ["kmerdist", "-i", maf, "-o", t / "kd.csv"]),
        ("benchmark -m 4", ["benchmark", "-m", "4", "-i", t / "out.sam",
                            "-o", t / "b4.json"]),
        ("benchmark -m 1", ["benchmark", "-m", "1", "-i", t / "out.sam",
                            "--refgenome", fa, "--cigarsfile",
                            t / "obs.csv", "--maxreads", BENCH_PROFILES]),
        ("benchmark -m 2", ["benchmark", "-m", "2", "--cigarsfile",
                            t / "obs.csv", "--refgenome", fa, "-o",
                            t / "sim.fa", "--maxreads", BENCH_PROFILES,
                            "--seed", "3"]),
        ("kalign of the replayed reads", ["kalign", "-i", t / "sim.fa",
                                          "-I", kix, "-o", t / "sim.sam"]),
        ("benchmark -m 3", ["benchmark", "-m", "3", "-i", t / "sim.sam",
                            "--groundtruth", t / "sim.fa", "-o",
                            t / "b3.json"]),
        ("benchmark -m 0", ["benchmark", "-m", "0", "-i", reads,
                            "-o", t / "lim.fq", "--maxreads", "1000"]),
        ("alignsbs", ["alignsbs", "-p", t / "sbs_q.fa", "-P", t / "asm.fa",
                      "-i", t / "sbs_t.fa", "-I", t / "asm.fa", "-b",
                      SBS_BOOT, "-r", "5", "-o", t / "sbs_q.csv", "-O",
                      t / "sbs_t.csv"]),
        ("ngsqc -H -", ["ngsqc", "-i", reads, "-o", t / "qc",
                        "-H", "-"]),
        ("maploci", ["maploci", "-i", t / "out.sam", "-b", t / "feats.bed",
                     "-o", t / "maploci.csv"]),
        ("simreads (rnade's experiment)", [
            "simreads", "-i", fa, "-o", t / "reads2.fa", "-n", RNADE_READS,
            "-l", READ_LEN, "-e", "illumina", "-z", "0.02", "-S", "11"]),
        ("kalign (rnade's experiment)", ["kalign", "-i", t / "reads2.fa",
                                         "-I", kix, "-o", t / "out2.sam"]),
        ("rnade", ["rnade", "-i", t / "out.sam", "-I", t / "out2.sam", "-g",
                   t / "genes.bed", "-o", t / "de.csv", "-O",
                   t / "bins.csv"])])
    faults = []
    kept = {r.name: len(r.codes) for r in read_seqs(t / "reduced.fa")}
    kept_len = sum(kept.values())
    lost = [f"u{i}" for i in range(HRDX_UNIQUE) if f"u{i}" not in kept]
    if lost or not 0.9 * HRDX_HAP <= kept_len <= 1.3 * HRDX_HAP:
        faults.append(f"hrdx: uniques lost {lost}, kept {kept_len} bp")
    want = mg.kmer_runs(psl, {"ecoli_sim": codes}, queries, 16)
    kd = _csv_rows(t / "kd.csv")
    npos = max(want["positions"], 1)
    if [(int(k), int(c), p) for k, c, p in kd] != [
            (k, want["counts"][k], f"{want['counts'][k] / npos:.6f}")
            for k in range(1, 17)]:
        faults.append(f"kmerdist {kd} differs from the direct count {want}")
    b4 = json.loads((t / "b4.json").read_text())
    b3 = json.loads((t / "b3.json").read_text())
    if b4["pct_correct_of_aligned"] < 99.9 or b4["aligned"] != b4["reads"] \
            or b4["reads"] < 0.95 * ECOLI_READS:
        faults.append(f"benchmark -m 4: {b4}")
    # -m 3 holds each reverse-strand read's truth loci reversed against
    # the SAM's forward claim, as the JAX package does (ROADMAP queue C):
    # its base precision is then about the forward share, and the checks
    # are on reads and on base recall
    if b3["scored"] < 0.95 * BENCH_PROFILES or b3["precision_reads"] < 0.99 \
            or b3["recall_bases"] < 0.99:
        faults.append(f"benchmark -m 3: {b3}")
    if sum(1 for _ in read_seqs(t / "lim.fq")) != 1_000:
        faults.append("benchmark -m 0 kept another count than 1,000")
    sq, st = _csv_rows(t / "sbs_q.csv"), _csv_rows(t / "sbs_t.csv")
    q_end = q_at + np.array(qs)
    over = (t_at[None, :] < q_end[:, None]) & \
        (t_at[None, :] + 2_000 > q_at[:, None])     # iteration 0, direct
    if len(sq) != SBS_BOOT + 1 or (int(sq[0][2]), int(st[0][2])) != (
            int(over.any(axis=1).sum()), int(over.any(axis=0).sum())) \
            or any(int(r[2]) < 0.9 * SBS_QUERIES for r in sq[1:]) \
            or any(int(r[2]) < 0.9 * SBS_TARGETS for r in st[1:]):
        faults.append(f"alignsbs: queries {sq}, targets {st}; iteration 0 "
                      f"direct {int(over.any(axis=1).sum())} queries, "
                      f"{int(over.any(axis=0).sum())} targets")
    qc = json.loads(printed["ngsqc -H -"])
    if qc["reads"] != ECOLI_READS or qc["max_len"] != READ_LEN:
        faults.append(f"ngsqc: {qc}")
    starts = np.sort(np.array([int(r.split("\t")[3]) - 1 for r in (
        t / "out.sam").read_text().splitlines()
        if not r.startswith("@") and not int(r.split("\t")[1]) & 4]))
    direct = {f"f{i}": int(np.searchsorted(starts, e, "left")
                           - np.searchsorted(starts, s - READ_LEN, "right"))
              for i, (s, e) in enumerate(zip(f_at, f_at + f_len))}
    got = {r[0].strip('"'): int(r[1]) for r in _csv_rows(t / "maploci.csv")}
    if got != {k: v for k, v in direct.items() if v}:
        faults.append("maploci differs from the direct overlap count")
    de = _csv_rows(t / "de.csv")
    folds = [float(r[17]) for r in de if int(r[4])]
    if len(de) != RNADE_GENES or len(folds) < 0.9 * RNADE_GENES or \
            np.mean([0.5 < f < 2.0 for f in folds]) < 0.9:
        faults.append(f"rnade: {len(de)} features, {len(folds)} scored")
    print(f"16c on {card}: hrdx kept {len(kept)} contigs, {kept_len} bp "
          f"({kept_len / HRDX_HAP} of a haplotype); kmerdist over "
          f"{want['blocks']} hits, {want['positions']} columns, 16-mers "
          f"{want['counts'][16]}; benchmark -m 4 {b4}; -m 3 {b3}; alignsbs "
          f"queries hitting {[int(r[2]) for r in sq]}, targets hit "
          f"{[int(r[2]) for r in st]}; ngsqc {qc}; maploci {len(got)} "
          f"features hit, {sum(got.values())} reads; rnade {len(de)} "
          f"features, {len(folds)} scored; faults {faults or 'none'}")
    if faults:
        raise AssertionError(f"phase 16c: {faults}")


HAP_COV = 5               # phase 17b: reads a base of each sample
HAP_SNP_RATE = 0.005      # founder B's SNPs against A (config #1's genome)
HAP_SEG = (100_000, 500_000)    # the progeny's mosaic segments, bp
HAP_PROGENY = 4           # the last one carries a heterozygous run
HAP_BIN = 10_000          # callhaplotypes' and seghaplotypes' default bin
HAP_CUT = 100_000         # the grouping modes' cut of the PBAs, bp
HAP_QTLS = 2_000          # dgts' QTL loci, from B's planted SNPs
HAP_GBS = 6_000           # GBS loci, from B's planted SNPs


def haplotypes_golden(torch, dev):
    """Phase 17a: every mode of the PBA and haplotype commands on the
    seeded workload of `make_haplotypes_golden`, through the port's CLI,
    against the JAX package's committed golden (host only)."""
    from kit4b_tpu_torch.tools import make_haplotypes_golden as mg
    t0 = time.perf_counter()
    out = mg.compute(mg.port_fns())
    with np.load(mg.GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    bad = mg.differing(out, gold)
    print(f"haplotypes golden: {len(out)} arrays of {len(mg.RUNS)} CLI runs "
          f"in {time.perf_counter() - t0} s; differing: {bad or 'none'}; "
          f"edges missed: {mg.check_reach(out) or 'none'}")
    if bad:
        raise AssertionError(f"the haplotypes golden differs: {bad[:10]}")


def hap_mosaic(rng, n: int, het: bool) -> list[tuple[int, int, str]]:
    """A progeny's planted mosaic of founders A and B over `n` bases:
    segments of HAP_SEG bp, alternating from a random first founder; with
    `het`, the second segment is heterozygous ('AB')."""
    segs, at = [], 0
    who = "AB"[int(rng.integers(0, 2))]
    while at < n:
        end = min(n, at + int(rng.integers(*HAP_SEG)))
        if n - end < HAP_SEG[0]:
            end = n
        segs.append([at, end, who])
        who = "B" if who == "A" else "A"
        at = end
    if het:
        segs[1][2] = "AB"
    return [tuple(s) for s in segs]


def _hap_sim(job):
    """Simulates one sample's error-free reads from its haplotype(s) and
    writes them as FASTA (run in a worker process)."""
    path, haps, n_reads, seed = job
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.io.fasta import Genome
    from kit4b_tpu_torch.sim import simreads
    recs = []
    for i, codes in enumerate(haps):
        g = Genome(["ecoli_sim"], np.array([0]), np.array([len(codes)]),
                   np.append(codes, dna.BASE_EOG).astype(np.uint8))
        recs += simreads.sim_reads(g, simreads.SimParams(
            n_reads=n_reads // len(haps), read_len=READ_LEN,
            seed=seed + i, error_mode="none"))
    simreads.write_reads(path, recs)
    return len(recs)


def _bin_truth(segs, n_bins: int) -> list:
    """Per HAP_BIN bin: the planted label, or None where a switch falls
    inside the bin."""
    out = []
    for b in range(n_bins):
        lo, hi = b * HAP_BIN, (b + 1) * HAP_BIN
        labs = {w for s, e, w in segs if s < hi and e > lo}
        out.append(labs.pop() if len(labs) == 1 else None)
    return out


def haplotypes_full(torch, dev, card, tmp: Path, cfg1: Path):
    """Phase 17b: the breeder's pipeline on config #1's genome, fed by
    kalign on the card. Founder A is the genome, founder B A with
    HAP_SNP_RATE seeded SNPs; HAP_PROGENY progeny are mosaics of A and B
    in segments of 100-500 kbp, the last with a heterozygous run. Each
    sample's error-free 100 bp reads (HAP_COV x, the port's simreads)
    go through one CLI `kalign -S -3` on the card (B's also with -X), and
    the PBAs, SNP CSVs and a pangenome alignment through every command of
    the family, each step timed. Checks against the planted truth:
    callhaplotypes' raw bins and its raw bins under the outlier rule alone
    (what --wwrlproxwindow 0 writes) at the planted founder outside switch
    bins (>= 95 %), the heterozygous run called FaFb (>= 90 %, imputed
    too);
    the imputed share at the defaults is printed (the runs test spreads a
    switch bin's FaFb call; ROADMAP.md queue C), as is mode 9's selection
    by scores; repassemb turning A into B at the SNPs kalign called
    (>= 99 %) and nowhere else; markerseqs' flanks equal to the genome;
    pbautils -m 0's bases and -m 4's loci among B's SNPs with their recall
    (>= 90 % of the covered); seghaplotypes' segments of a progeny aligned
    to the pangenome (>= 95 % of bins); gbsmapsnps' calls (>= 99 %);
    dgts' reference at every QTL; snpmarkers on B's SNPs; lochap2bed and
    snps2pgsnps a row a DiSNP and SNP; concat's and pangenome -m 1's
    counts.

    Cuts: a random genome; six samples; error-free reads (one error among
    two to four reads makes a PBA variant at 5x); the grouping modes (3-6,
    10) on the first HAP_CUT bp of the PBAs (diff_matrix's affine-gap walk
    and group_kmers step through the loci in Python: their seconds a locus
    are printed)."""
    from kit4b_tpu_torch import cli, dna
    from kit4b_tpu_torch.io.fasta import Genome, read_seqs
    from kit4b_tpu_torch.kmer import callhaplotypes, haplogroups, pba
    fa, kix = config1_files(cfg1)
    rng = np.random.default_rng(SEED + 1700)
    A = Genome.load(fa).chrom_codes(0).copy()
    n = len(A)
    snp_at = np.sort(rng.choice(n, int(n * HAP_SNP_RATE), replace=False))
    B = A.copy()
    B[snp_at] = (A[snp_at] + rng.integers(1, 4, len(snp_at))) % 4
    progeny = [f"P{i + 1}" for i in range(HAP_PROGENY)]
    mosaics = {p: hap_mosaic(rng, n, i == HAP_PROGENY - 1)
               for i, p in enumerate(progeny)}
    het_p = progeny[-1]

    def hap(segs, het_from):
        mask = np.zeros(n, bool)
        for s, e, w in segs:
            mask[s:e] = w == "B" or (w == "AB" and het_from == "B")
        return np.where(mask, B, A)
    haps = {"A": [A], "B": [B]}
    for p in progeny:
        haps[p] = [hap(mosaics[p], "A")] + (
            [hap(mosaics[p], "B")] if p == het_p else [])
    n_reads = HAP_COV * n // READ_LEN
    t = tmp
    steps_s = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(haps), mp_context=get_context("spawn")) \
            as pool:
        sims = {s: pool.submit(_hap_sim, (t / f"{s}.fa", h, n_reads,
                                          170 + i))
                for i, (s, h) in enumerate(haps.items())}
        pangenome = []
        for f, p in ((fa, "A"), (t / "B_genome.fa", "B")):
            if p == "B":
                write_fasta(f, ["ecoli_sim"], [B])
            if cli.main(["pangenome", "-m", "0", "-p", p, "-i", str(f),
                         "-o", str(t / f"pg{p}.fa")]) != 0:
                raise AssertionError(f"CLI pangenome -m 0 -p {p} failed")
            pangenome.append((t / f"pg{p}.fa").read_text())
        (t / "pangenome.fa").write_text("".join(pangenome))
        n_sim = {s: f.result() for s, f in sims.items()}
    steps_s["simreads (6 samples at once) and pangenome -m 0"] = \
        time.perf_counter() - t0
    # the pangenome's index builds on the host while the card aligns
    t_pg = time.perf_counter()
    pg_index = subprocess.Popen(
        [sys.executable, "-m", "kit4b_tpu_torch", "index", "-i",
         str(t / "pangenome.fa"), "-o", str(t / "pangenome.kix")],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        kalign_s = {}
        for s in haps:
            log = _PhaseLog()
            logging.getLogger("kit4b_tpu_torch").addHandler(log)
            argv = ["kalign", "-i", str(t / f"{s}.fa"), "-I", str(kix), "-o",
                    str(t / f"{s}.sam") if s == "B" else os.devnull,
                    "-b", str(ECOLI_BATCH), "-S", str(t / f"{s}.csv"), "-3",
                    str(t / f"{s}.pba.npz"), "--device", dev.type] + (
                        ["-X", str(t / "B")] if s == "B" else [])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                rc = cli.main(argv)
            finally:
                logging.getLogger("kit4b_tpu_torch").removeHandler(log)
            kalign_s[s] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"CLI kalign -S -3 of {s} exited {rc}")
            print(f"CLI kalign -S -3{' -X' if s == 'B' else ''} of {s} "
                  f"({n_sim[s]} reads) on {card}: "
                  f"{kalign_s[s]} s, phases {log.seconds}; classes "
                  f"{log.stats}")
        out, _ = pg_index.communicate(timeout=600)
    finally:
        if pg_index.poll() is None:
            pg_index.kill()
            pg_index.wait()
    steps_s["kalign -S -3 (6 samples)"] = sum(kalign_s.values())
    steps_s["kalign runs and the pangenome's index beside them"] = \
        time.perf_counter() - t_pg
    if pg_index.returncode != 0:
        raise AssertionError(f"index of the pangenome exited "
                             f"{pg_index.returncode}: {out[-2000:]}")
    print("CLI index of the pangenome (a subprocess beside the kalign "
          "runs): " + "; ".join(
              ln.split("INFO: ", 1)[-1].strip() for ln in out.splitlines()
              if ("phase " in ln and not ln.endswith("start"))
              or "done in" in ln))
    # the PBAs in both containers, each named by its sample (kalign -3
    # names every readset 'readset')
    pbas = {}
    for s in haps:
        pbas[s] = pba.load_pba(t / f"{s}.pba.npz")[1]
        pba.save_pba_ref(t / f"{s}.pba", pbas[s], readset=s)
    cut = {}
    for s in haps:
        cut[s] = {"ecoli_sim": pbas[s]["ecoli_sim"][:HAP_CUT]}
        pba.save_pba_ref(t / f"{s}.cut.pba", cut[s], readset=s)
    named = [f"{s}={t / f'{s}.pba'}" for s in haps]
    cut_named = [f"{s}={t / f'{s}.cut.pba'}" for s in haps]
    prog_named = [f"{p}={t / f'{p}.pba.npz'}" for p in progeny]
    founders = ["A=" + str(t / "A.pba"), "B=" + str(t / "B.pba.npz")]
    all_pba = [str(t / f"{s}.pba") for s in haps]
    # GBS genotypes and QTLs at B's planted SNPs
    def geno(byte):
        al = [b for i, b in enumerate("ACGT") if (byte >> (6 - 2 * i)) & 3]
        return "NA" if not al else (al[0] * 2 if len(al) == 1
                                    else "".join(al[:2]))
    gbs_at = np.sort(rng.choice(snp_at, HAP_GBS, replace=False))
    cols = ["A", "B"] + progeny
    for k, sel in ((1, gbs_at[0::2]), (2, gbs_at[1::2])):
        (t / f"gbs{k}.csv").write_text(
            "SNPID,Chrom,Loci," + ",".join(
                ["FounderA", "FounderB"] + progeny) + "\n" + "".join(
                f"s{x},chrE,{x}," + ",".join(
                    geno(int(pbas[c]["ecoli_sim"][x])) for c in cols)
                + "\n" for x in sel.tolist()))
    (t / "map.csv").write_text("alias,chrom\nchrE,ecoli_sim\n")
    qtl_at = np.sort(rng.choice(snp_at, HAP_QTLS, replace=False))
    (t / "qtl.csv").write_text('"Chrom","Loci","Ref","Alt"\n' + "".join(
        f'"ecoli_sim",{x},"{"ACGT"[A[x]]}","{"ACGT"[B[x]]}"\n'
        for x in qtl_at.tolist()))
    grp = ["-g", "25000", "-n", "1", "--grpdgtsamples", "0.1"]
    steps = [
        ("pbautils -m 1", ["pbautils", "-m", "1", "-i", fa, "-o",
                           t / "ref.pba.npz"]),
        ("pbautils -m 0", ["pbautils", "-m", "0", "-i", t / "B.pba", "-o",
                           t / "B.pba.fa"]),
        ("pbautils -m 2", ["pbautils", "-m", "2", "-i", *all_pba, "-o",
                           t / "conc.csv"]),
        ("pbautils -m 3", ["pbautils", "-m", "3", "-i", *all_pba, "-o",
                           t / "wconc.csv"]),
        ("pbautils -m 4", ["pbautils", "-m", "4", "-r", t / "ref.pba.npz",
                           "-i", t / "B.pba", "-o", t / "B.allelic.vcf"]),
        ("pbautils -m 5", ["pbautils", "-m", "5", "-r", t / "ref.pba.npz",
                           "-i", *all_pba, "-o", t / "gt.vcf"]),
        ("pbautils -m 6", ["pbautils", "-m", "6", "-r", t / "ref.pba.npz",
                           "-i", *all_pba, "--gtprophet", "0.1", "-o",
                           t / "dip.vcf"]),
        ("pbautils -m 7", ["pbautils", "-m", "7", "-r", t / "ref.pba.npz",
                           "-i", *all_pba[:2], "-o", t / "del.vcf"]),
        ("pbautils -m 8", ["pbautils", "-m", "8", "-i", *all_pba, "-o",
                           t / "tx.bed"]),
        ("pbautils -m concat", ["pbautils", "-m", "concat", "-i",
                                *[t / f"{p}.pba.npz" for p in progeny],
                                "-o", t / "cat.pba.npz"]),
        ("pbautils -m coverage", ["pbautils", "-m", "coverage", "-i",
                                  t / "A.pba.npz", "-o", t / "A.cov.wig"]),
        ("callhaplotypes -m 2", ["callhaplotypes", "-m", "2", "-c",
                                 *founders, "-i", *prog_named, "-o",
                                 t / "ch"]),
        ("callhaplotypes -m 7", ["callhaplotypes", "-m", "7", "-c",
                                 *founders, "-i", *prog_named, "-o",
                                 t / "m7.csv"]),
        ("callhaplotypes -m 8", ["callhaplotypes", "-m", "8", "-c",
                                 *named, "-o", t / "m8.csv"]),
        ("callhaplotypes -m 9", ["callhaplotypes", "-m", "9", "-A",
                                 t / "m7.csv", "-o", t / "m9"]),
        ("callhaplotypes -m 11", ["callhaplotypes", "-m", "11", "-A",
                                  t / "m7.csv", "-r", "^P1$", "-o",
                                  t / "m11.csv"]),
        ("callhaplotypes -m 12", ["callhaplotypes", "-m", "12", "-A",
                                  t / "m7.csv", "-o", t / "m12.csv"]),
        ("callhaplotypes -m 3 (cut)", ["callhaplotypes", "-m", "3", "-c",
                                       *cut_named, *grp, "-o",
                                       t / "m3.csv"]),
        ("callhaplotypes -m 4 (cut)", ["callhaplotypes", "-m", "4", "-c",
                                       *cut_named, *grp, "-o",
                                       t / "m4.csv"]),
        ("callhaplotypes -m 5 (cut)", ["callhaplotypes", "-m", "5", "-c",
                                       *cut_named, *grp, "-o",
                                       t / "m5.csv"]),
        ("callhaplotypes -m 6 (cut)", ["callhaplotypes", "-m", "6", "-c",
                                       *cut_named, *grp, "-o",
                                       t / "m6.wig"]),
        ("callhaplotypes -m 10 (cut)", ["callhaplotypes", "-m", "10", "-c",
                                        *cut_named, *grp, "-o",
                                        t / "m10.csv"]),
        ("dgts -m 1", ["dgts", "-m", "1", "-Q", t / "qtl.csv", "-D",
                       t / "m5.csv", "-I", t / "ref.pba.npz", "-i", *named,
                       "-o", t / "dgts.csv"]),
        ("snpmarkers", ["snpmarkers", "-c", f"A={t / 'A.csv'}",
                        f"B={t / 'B.csv'}", "-o", t / "markers.csv"]),
        ("snps2pgsnps", ["snps2pgsnps", "-i", t / "B.csv", "-o",
                         t / "B.pgsnp"]),
        ("snps2pgsnps .vcf", ["snps2pgsnps", "-i", t / "B.csv", "-o",
                              t / "B.vcf"]),
        ("markerseqs", ["markerseqs", "-i", t / "B.csv", "-g", fa, "-o",
                        t / "mseq.csv"]),
        ("repassemb", ["repassemb", "-i", t / "B.csv", "-g", fa, "-o",
                       t / "rep.fa"]),
        ("lochap2bed", ["lochap2bed", "-i", t / "B.disnp.csv", "-o",
                        t / "B.disnp.bed"]),
        ("gbsmapsnps -m 0", ["gbsmapsnps", "-i", t / "gbs1.csv", "-I",
                             t / "map.csv", "-o", t / "hap1.csv"]),
        ("gbsmapsnps -m 0 (second half)", [
            "gbsmapsnps", "-i", t / "gbs2.csv", "-I", t / "map.csv", "-o",
            t / "hap2.csv"]),
        ("gbsmapsnps -m 1", ["gbsmapsnps", "-m", "1", "-i", t / "hap1.csv",
                             "-I", t / "hap2.csv", "-o", t / "comb.csv"])]
    t0 = time.perf_counter()
    cmd_s = {}
    _cli_steps(card, steps, cmd_s)
    steps_s["the family's commands on the PBAs"] = time.perf_counter() - t0
    seg_p = progeny[0]
    t0 = time.perf_counter()
    _cli_steps(card, [
        (f"kalign of {seg_p} onto the pangenome", [
            "kalign", "-i", t / f"{seg_p}.fa", "-I", t / "pangenome.kix",
            "-o", t / "pg.sam", "-b", ECOLI_BATCH, "--device", dev.type]),
        ("pangenome -m 1", ["pangenome", "-m", "1", "-p", "A", "-i",
                            t / "pg.sam", "-o", t / "pgA.sam"]),
        ("pangenome -m 2", ["pangenome", "-m", "2", "-i", t / "pg.sam",
                            "-o", t / "pg2.wig"]),
        ("pangenome -m 3", ["pangenome", "-m", "3", "-i", t / "pg.sam",
                            "-o", t / "pg3.wig"]),
        ("seghaplotypes", ["seghaplotypes", "-i", t / "pg.sam", "-o",
                           t / "seg.bed"])])
    steps_s["pangenome kalign, pangenome 1-3, seghaplotypes"] = \
        time.perf_counter() - t0
    # the cost of the grouping modes' per-locus Python walks
    mats = np.stack([cut[s]["ecoli_sim"] for s in haps])
    t0 = time.perf_counter()
    haplogroups.diff_matrix(mats, affine_gap_len=3)
    affine_s = (time.perf_counter() - t0) / HAP_CUT

    faults = []
    n_bins = -(-n // HAP_BIN)
    share = {}       # per output: bins at the planted founder, bins checked
    het_bins = {}    # per output: the heterozygous run's bins called FaFb
    for key, pat in (("raw", "ch.{}.raw.csv"), ("imputed", "ch.{}.csv"),
                     ("outliers only", "ch.{}.raw.csv")):
        ok = n_chk = het_ok = n_het = 0
        for p in progeny:
            truth = _bin_truth(mosaics[p], n_bins)
            calls = [r[3].strip('"') for r in _csv_rows(t / pat.format(p))]
            if key == "outliers only":   # what --wwrlproxwindow 0 writes
                calls = [c.call for c in callhaplotypes.impute_outliers([
                    callhaplotypes.BinCall("", i * HAP_BIN, 0, c, {}, 0)
                    for i, c in enumerate(calls)])]
            if len(calls) != n_bins:
                faults.append(f"callhaplotypes {key}: {len(calls)} bins")
            for want, got in zip(truth, calls):
                if want == "AB":
                    n_het += 1
                    het_ok += got == "FaFb"
                elif want is not None:
                    n_chk += 1
                    ok += got == want
        share[key], het_bins[key] = (ok, n_chk), (het_ok, n_het)
    # the runs test spreads a switch bin's FaFb call over its neighbours,
    # then the second pass over whole segments (ROADMAP.md queue C): the
    # imputed share is printed, and held on the raw calls and on the
    # outlier rule alone
    for key in ("raw", "outliers only"):
        ok, n_chk = share[key]
        if ok < 0.95 * n_chk:
            faults.append(f"callhaplotypes {key}: {ok} of {n_chk} bins at "
                          "the planted founder")
    for key in ("raw", "imputed", "outliers only"):
        ok, n_het = het_bins[key]
        if ok < 0.9 * n_het:
            faults.append(f"callhaplotypes {key}: {ok} of {n_het} bins of "
                          "the heterozygous run called FaFb")
    b_snps = [(int(r[4]), r[12].strip('"')) for r in _csv_rows(t / "B.csv")]
    called_at = np.array([x for x, _ in b_snps], np.int64)
    rep = next(iter(read_seqs(t / "rep.fa"))).codes
    planted = np.zeros(n, bool)
    planted[snp_at] = True
    turned = int((rep[called_at] == B[called_at]).sum())
    others = np.ones(n, bool)
    others[called_at] = False
    if turned < 0.99 * len(called_at) or \
            not np.array_equal(rep[others], A[others]) or \
            not planted[called_at].all():
        faults.append(f"repassemb: {turned} of {len(called_at)} called loci "
                      f"turned to B, others changed "
                      f"{int((rep[others] != A[others]).sum())}, called "
                      f"loci not planted {int((~planted[called_at]).sum())}")
    flank_bad = 0
    mseq = _csv_rows(t / "mseq.csv")
    for r in mseq:
        x = int(r[2])
        five, three = r[3].strip('"'), r[6].strip('"')
        flank_bad += (five != dna.decode(A[max(0, x - 25):x])
                      or three != dna.decode(A[x + 1:x + 26])
                      or r[4].strip('"') != "ACGT"[A[x]])
    if flank_bad or len(mseq) != len(b_snps):
        faults.append(f"markerseqs: {flank_bad} of {len(mseq)} flanks "
                      "differ from the genome")
    vcf_at = np.array([int(ln.split("\t")[1]) - 1 for ln in (
        t / "B.allelic.vcf").read_text().splitlines()
        if not ln.startswith("#")], np.int64)
    covered = snp_at[pbas["B"]["ecoli_sim"][snp_at] > 0]
    recall = np.isin(covered, vcf_at).mean()
    if not planted[vcf_at].all() or recall < 0.9:
        faults.append(f"pbautils -m 4: {int((~planted[vcf_at]).sum())} loci "
                      f"not planted, recall {recall}")
    bfa = next(iter(read_seqs(t / "B.pba.fa"))).codes
    bcov = pbas["B"]["ecoli_sim"] > 0
    if not np.array_equal(bfa[bcov], B[bcov]):
        faults.append("pbautils -m 0: covered bases differ from B")
    seg_truth = _bin_truth(mosaics[seg_p], n_bins)
    seg_called = {"A": np.zeros(n_bins, bool), "B": np.zeros(n_bins, bool)}
    for f in ("A", "B"):
        for ln in (t / f"seg.bed.{f}.bed").read_text().splitlines()[1:]:
            c = ln.split("\t")
            seg_called[f][int(c[1]) // HAP_BIN:-(-int(c[2]) // HAP_BIN)] = \
                True
    seg_ok = seg_n = 0
    for b, want in enumerate(seg_truth):
        if want is None:
            continue
        seg_n += 1
        seg_ok += {f for f in "AB" if seg_called[f][b]} == set(want)
    if seg_ok < 0.95 * seg_n:
        faults.append(f"seghaplotypes: {seg_ok} of {seg_n} bins of {seg_p} "
                      "at its mosaic")
    sel = [ln.split(",") for ln in (t / "m9.selected.csv").read_text()
           .splitlines()[1:]]
    m9_ok = m9_n = 0
    for r in sel:
        lo, size = int(r[2]), int(r[3])
        for j, p in enumerate(progeny[:-1]):
            labs = {w for s, e, w in mosaics[p] if s < lo + size and e > lo}
            if len(labs) == 1:
                m9_n += 1
                m9_ok += r[4 + j].strip('"') == labs.pop()
    code = {"A": 1, "B": 2}
    gbs_ok = gbs_n = 0
    comb = _csv_rows(t / "comb.csv")
    for r in comb:
        x = int(r[2])
        for j, p in enumerate(progeny[:-1]):
            call = int(r[5 + j])
            want = [w for s, e, w in mosaics[p] if s <= x < e][0]
            if call != -1:
                gbs_n += 1
                gbs_ok += call == code[want]
    if gbs_ok < 0.99 * gbs_n or len(comb) != len(_csv_rows(
            t / "hap1.csv")) + len(_csv_rows(t / "hap2.csv")):
        faults.append(f"gbsmapsnps: {gbs_ok} of {gbs_n} calls at the planted "
                      f"founder, {len(comb)} combined rows")
    dg = _csv_rows(t / "dgts.csv")
    qtl_rows = [r for r in dg if r[3] == "2"]
    if len(qtl_rows) != HAP_QTLS or any(r[13] != "0" for r in qtl_rows):
        faults.append(f"dgts: {len(qtl_rows)} QTL rows, "
                      f"{sum(r[13] != '0' for r in qtl_rows)} whose "
                      "reference mismatches the QTL's")
    mk = _csv_rows(t / "markers.csv")
    mk_at = np.array([int(r[2]) for r in mk], np.int64)
    if not len(mk) or not planted[mk_at].all():
        faults.append(f"snpmarkers: {len(mk)} markers, "
                      f"{int((~planted[mk_at]).sum())} off B's SNPs")
    di = len(_csv_rows(t / "B.disnp.csv"))
    bed = len((t / "B.disnp.bed").read_text().splitlines())
    vcf = sum(1 for ln in (t / "B.vcf").read_text().splitlines()
              if not ln.startswith("#"))
    if bed != di or vcf != len(b_snps):
        faults.append(f"lochap2bed {bed} of {di} DiSNPs, snps2pgsnps .vcf "
                      f"{vcf} of {len(b_snps)} SNPs")
    cat = pba.load_pba(t / "cat.pba.npz")[1]["ecoli_sim"]
    if len(cat) != n:
        faults.append(f"concat: {len(cat)} loci")
    pg_kept = sum(1 for ln in (t / "pgA.sam").read_text().splitlines()
                  if not ln.startswith("@"))
    pg_all = [ln.split("\t") for ln in (t / "pg.sam").read_text()
              .splitlines() if not ln.startswith("@")]
    if pg_kept != sum(r[2].startswith("A|#") for r in pg_all):
        faults.append("pangenome -m 1 kept another count than A's records")
    m3 = _csv_rows(t / "m3.csv")
    print(f"17b on {card}: genome {n} bp, B {len(snp_at)} SNPs, progeny "
          f"segments {[len(mosaics[p]) for p in progeny]}, {n_reads} reads "
          f"a sample; steps {steps_s}; callhaplotypes -m 2's bins at the planted "
          f"founder outside switch bins (of those checked) {share}, the "
          f"heterozygous run's bins called FaFb {het_bins}; kalign called {len(b_snps)} of "
          f"B's SNPs, repassemb turned {turned}; markerseqs {len(mseq)} "
          f"flanks, {flank_bad} differ; pbautils -m 4 {len(vcf_at)} loci, "
          f"recall {recall} of {len(covered)} covered; seghaplotypes "
          f"{seg_ok} of {seg_n} bins; mode 9's selection by scores at the "
          f"planted founder in {m9_ok} of {m9_n} bins; gbsmapsnps "
          f"{gbs_ok} of {gbs_n}; dgts {len(dg)} rows; snpmarkers {len(mk)}; "
          f"pangenome kalign {len(pg_all)} records; mode 3 {len(m3)} groups "
          f"over {-(-HAP_CUT // 25_000)} bins; seconds a locus over {len(haps)} "
          f"samples: diff_matrix's affine-gap walk {affine_s}, callhaplotypes"
          f" -m 3 {cmd_s['callhaplotypes -m 3 (cut)'] / HAP_CUT}, -m 10 "
          f"(group_kmers) {cmd_s['callhaplotypes -m 10 (cut)'] / HAP_CUT}; "
          f"faults "
          f"{faults or 'none'}")
    if faults:
        raise AssertionError(f"phase 17b: {faults}")
    return steps_s


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
    from kit4b_tpu_torch.kernels.sw import sw_scan, sw_traceback
    from kit4b_tpu_torch.kernels.sweep import sweep
    from kit4b_tpu_torch.kernels.take import take
    minmm.launches = sweep.launches = take.launches = 0
    sw_scan.launches = sw_traceback.launches = 0


class _PhaseLog(logging.Handler):
    """Keeps the unrounded seconds of the CLI's PhaseTimer phases,
    kalign's class counts and tier-1 pass by read length, paired-end
    kalign's pair counts and pair rows by stage, kmarkers' positions by
    tier and filter's reads removed by step."""

    def __init__(self):
        super().__init__()
        self.seconds = {}
        self.stats = self.tier1 = self.tiers = None
        self.pe_stats = self.pe_stages = None
        self.removed = {}

    def emit(self, record):
        if record.msg == "phase %s: %.2fs":
            self.seconds[record.args[0]] = record.args[1]
        elif str(record.msg).startswith("kalign: %d reads"):
            self.stats, self.tier1 = record.args[1], record.args[2]
        elif str(record.msg).startswith("kalign PE: %s"):
            self.pe_stats, self.pe_stages = record.args[0], record.args[1]
        elif str(record.msg).startswith("kmarkers: positions by tier"):
            self.tiers = record.args[0]
        elif record.msg == "filter %s: removed %d":
            self.removed[record.args[0]] = record.args[1]


def main() -> int:
    import torch
    t_start = time.perf_counter()
    phase_s = {}          # seconds of each phase, in order
    lap = [t_start]

    def done(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - lap[0]
        lap[0] = now
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
    kernels = ("minmm", "sweep", "take", "sw")
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

    done("1")

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

    done("2")

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

    done("3")

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

    done("4")

    # --- 5-7. the sweep kernel, the sweep engine, the gather ----------
    chr4 = synthetic_chr4(np.random.default_rng(SEED + 4))
    sweep_err, sweep_ms, sweep_plain_ms, sweep_bound = sweep_vs_plain(
        torch, dev, chr4, card)
    done("5")
    sweep_launches, chr4_min = sweep_engine(torch, dev, chr4, g,
                                            oracle_results, card)
    done("6")
    take_launches, take_err, take_ms, take_plain_ms, take_bound = gather(
        torch, dev)
    done("7")

    # --- 8. kalign: the JAX golden, then config #1 at full size -------
    kalign_golden(torch, dev)
    # config #1's genome, index, reads and SAM, written once by 8b and
    # read by 12b, 13b-d, 16b-c and 17b; removed when the run ends
    config1 = tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root)
    cfg1 = Path(config1.name)
    kalign_full(torch, dev, card, cfg1)
    done("8")

    # --- 9. kmarkers: the JAX golden, the brute force, config #3 ------
    kmarkers_golden(torch, dev)
    kmarkers_brute(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        kmarkers_full(torch, dev, card, Path(tmp))
    done("9")

    # --- 10. hammings -r: the golden, chrIV, the R64-length CLI run ----
    restricted_golden(torch, dev)
    restricted_chr4(torch, dev, chr4, chr4_min, card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        restricted_full(torch, dev, card, Path(tmp), chroms, seq, Gp)
    done("10")

    # --- 11. paired-end kalign: the JAX golden, config #4 at full size --
    # --- 12. full-stats kalign: the golden, -y -C, -l, unequal mates ----
    pe_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        pe_full(torch, dev, card, Path(tmp))
        done("11")
        kalign_full_golden(torch, dev)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                         dir=root) as tmp12:
            rescue_full(torch, dev, card, Path(tmp12), cfg1)
        pe_unequal_full(torch, dev, card, Path(tmp))
    done("12")

    # --- 13. kalign options, BAM, SNP outputs, bisulfite ----------------
    opts_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        opts_full(torch, dev, card, Path(tmp), cfg1)
        snp_full(torch, dev, card, Path(tmp), cfg1)
        bisulfite_full(torch, dev, card, Path(tmp), cfg1)
    done("13")

    # --- 14. config #5 and the float device uses ------------------------
    assembly_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        config5_full(torch, dev, card, Path(tmp))
        neardup_full(torch, dev, card, Path(tmp))
        float_full(torch, dev, card, Path(tmp))
    done("14")

    # --- 15. the PacBio long-read path: golden, kernels, pipeline -------
    pacbio_golden(torch, dev)
    sw_t = sw_kernels(torch, dev, card)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        sw_launches, pb_sha = pacbio_full(torch, dev, card, Path(tmp))
    if pb_sha != PB_SHA256:
        raise AssertionError(f"15c's outputs differ from the parent "
                             f"kernels': {pb_sha}")
    done("15")

    # --- 16. blitz, hrdx, kmerdist and the scorer group ------------------
    longtail_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        blitz_launches, *blitz_out = blitz_full(torch, dev, card, Path(tmp),
                                                cfg1)
        longtail_full(torch, dev, card, Path(tmp), cfg1, *blitz_out)
    for k in sw_launches:
        sw_launches[k] += blitz_launches[k]
    done("16")

    # --- 17. the PBA and haplotype family: golden, the pipeline ---------
    haplotypes_golden(torch, dev)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=root) as tmp:
        haplotypes_full(torch, dev, card, Path(tmp), cfg1)
    config1.cleanup()
    done("17")
    if "jax" in sys.modules or "kit4b_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package kit4b_tpu was imported")

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start} s; seconds by phase "
          f"{json.dumps(phase_s)}")
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
         "bound_by": "bytes", "library_ms": None},
        {"name": "sw_scan", "route": "cuda",
         "source": "kit4b_tpu_torch/csrc/sw.cu",
         "replaces": "kit4b_tpu/pacbio/sswd.py:48",
         "launches": sw_launches["sw_scan"], "max_abs_err": 0,
         "ms": sw_t["scan_ms"], "plain_ms": sw_t["scan_plain_ms"],
         "bound_ms": sw_t["scan_bound"], "bound_by": sw_t["scan_by"],
         "library_ms": None},
        {"name": "sw_traceback", "route": "cuda",
         "source": "kit4b_tpu_torch/csrc/sw.cu",
         "replaces": "kit4b_tpu/pacbio/sswd.py:122",
         "launches": sw_launches["sw_traceback"], "max_abs_err": 0,
         "ms": sw_t["tb_ms"], "plain_ms": sw_t["tb_plain_ms"],
         "bound_ms": sw_t["tb_bound"], "bound_by": "bytes",
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
