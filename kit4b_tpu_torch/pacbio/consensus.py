"""Multi-alignment consensus over SW overlaps (CMAConsensus equivalent),
the port's copy of kit4b_tpu/pacbio/consensus.py (host numpy).

The reference builds a multi-alignment of every accepted overlap against the
probe and majority-calls each column including insertion columns
(pacbiokit4b/MAConsensus.cpp). Here each SWAlignment's op walk deposits
evidence per probe position:
  - M ops vote the target base at that probe position
  - D ops (gap in target) vote for deleting the probe base
  - I ops (extra target bases) vote an insertion string after the previous
    probe position
The probe's own bases are seeded with weight 1, so an uncovered column keeps
the raw read base — same fall-through as the reference when coverage is
absent."""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class ConsensusBuilder:
    def __init__(self, probe: np.ndarray):
        self.probe = np.asarray(probe, np.uint8)
        L = len(probe)
        self.base_votes = np.zeros((L, 4), np.int32)
        ok = self.probe < 4
        self.base_votes[np.arange(L)[ok], self.probe[ok]] = 1
        self.del_votes = np.zeros(L, np.int32)
        self.cov = np.ones(L, np.int32)       # probe itself
        self.ins: dict[int, dict[bytes, int]] = defaultdict(
            lambda: defaultdict(int))
        self.ins_cov = np.zeros(L + 1, np.int32)
        self.n_overlaps = 0

    def add(self, aln, target: np.ndarray) -> None:
        """Deposit one accepted overlap (SWAlignment vs this probe)."""
        i, c = aln.p_start, aln.t_start
        self.n_overlaps += 1
        self.cov[aln.p_start: aln.p_end] += 1
        self.ins_cov[aln.p_start: aln.p_end + 1] += 1
        for op, n in aln.ops:
            if op == "M":
                tb = target[c: c + n]
                ok = tb < 4
                self.base_votes[np.arange(i, i + n)[ok], tb[ok]] += 1
                i += n
                c += n
            elif op == "D":
                self.del_votes[i: i + n] += 1
                i += n
            else:  # I: insertion before probe position i
                frag = bytes(target[c: c + n])
                self.ins[i][frag] += 1
                c += n

    def call(self, min_coverage: int = 2) -> np.ndarray:
        """Majority call. Columns with coverage < min_coverage keep the raw
        probe base (no correction evidence)."""
        L = len(self.probe)
        out = []
        for i in range(L):
            if i in self.ins and self.ins[i]:
                best, votes = max(self.ins[i].items(), key=lambda kv: kv[1])
                if (self.ins_cov[i] >= min_coverage
                        and votes * 2 > self.ins_cov[i]):
                    out.extend(best)
            if self.cov[i] < min_coverage:
                out.append(int(self.probe[i]))
                continue
            if self.del_votes[i] * 2 > self.cov[i]:
                continue  # majority says the probe base is an insertion
            out.append(int(np.argmax(self.base_votes[i])))
        return np.asarray(out, np.uint8)
