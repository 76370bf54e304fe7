"""kmerdist: exact-matching K-mer distributions from MAF alignments, the
port's copy of kit4b_tpu/pacbio/kmerdist.py (host numpy, the run-length
loop per column as the original has it).

CMAFKMerDist equivalent (pacbiokit4b/MAFKMerDist.cpp): for pairwise MAF
blocks (probe row + target row) count, for each K, the alignment positions
starting a run of K columns where probe and target bases are both present
and identical — the exact-K-mer concordance distribution used to profile
error-corrected read quality."""
from __future__ import annotations

import numpy as np

from ..io.maf import read_maf


def kmer_dist(maf_path, max_k: int = 16) -> dict:
    """Returns {"counts": [max_k+1], "positions": N, "blocks": B} where
    counts[k] = #positions starting >= k consecutive matching columns."""
    counts = np.zeros(max_k + 1, np.int64)
    npos = 0
    nblk = 0
    for blk in read_maf(maf_path):
        if len(blk.seqs) < 2:
            continue
        nblk += 1
        a = blk.seqs[0].codes
        for other in blk.seqs[1:]:
            b = other.codes
            n = min(len(a), len(b))
            m = (a[:n] == b[:n]) & (a[:n] < 4) & (b[:n] < 4)
            npos += n
            # run length starting at each position via reverse cumulative
            run = np.zeros(n + 1, np.int32)
            for i in range(n - 1, -1, -1):
                run[i] = run[i + 1] + 1 if m[i] else 0
            for k in range(1, max_k + 1):
                counts[k] += int((run[:n] >= k).sum())
    return {"counts": counts.tolist(), "positions": npos, "blocks": nblk}


def write_kmer_dist(path, dist: dict) -> None:
    with open(path, "w") as f:
        f.write('"K","exact_kmers","per_position"\n')
        npos = max(dist["positions"], 1)
        for k in range(1, len(dist["counts"])):
            c = dist["counts"][k]
            f.write(f'{k},{c},{c/npos:.6f}\n')
