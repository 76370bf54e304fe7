"""Job `hammings_restricted`: restricted-mode genome-wide minimum K-mer
Hamming distances (`hammings -r <r> -K <K>`).

One unit is what the CLI's `sweep` phase of `-r` does: the native SA-IS
suffix index of the genome (`index/sfx_index.py` `SfxIndex.build`), then
`kmer/hammings.py` `hammings_restricted`, whose pigeonhole probes run the
seed-and-extend pass `ops/seed_extend_fast.fast_pass` that kalign's host
ladder runs too. Set-up makes the genome and runs one unit on its first
chromosome alone, which loads the host library and runs every device
operation of the pass at the timed batch.

The check: every unit returned the first unit's distances; on clean
windows drawn from the seed (uniform, and inside the planted near-copies)
the first unit's capped distances keep restricted mode's guarantee against
the plain reference's true minimum; windows drawn from the N runs (more
than 4 Ns) read 0.
"""
from __future__ import annotations

import numpy as np

from ..reference import hammings as ref
from .hammings_node import make_genome, sample_positions

SPANS = [
    ("kit4b_tpu_torch.index.sfx_index", "SfxIndex.build", "restricted.sais"),
    ("kit4b_tpu_torch.ops.seed_extend_fast", "fast_pass",
     "restricted.fast_pass"),
    ("kit4b_tpu_torch.kmer.hammings", "hammings_restricted",
     "restricted.probe"),
]


def _genome(names, chroms):
    from kit4b_tpu_torch.io.fasta import Genome
    from ..recipes import concat
    starts = np.cumsum([0] + [len(c) + 1 for c in chroms[:-1]])
    return Genome(list(names), starts.astype(np.int64),
                  np.array([len(c) for c in chroms], np.int64),
                  concat(chroms))


class Job:
    """The genome of one run; `unit` is one index build and sweep."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tmpdir: str):
        self.seed, self.device = seed, device
        self.K = int(config["K"])
        self.antisense = bool(config["antisense"])
        self.r = int(traffic["max_hamming"])
        self.check_n = (int(traffic["check_random"]),
                        int(traffic["check_planted"]),
                        int(traffic["check_n_runs"]))
        self.names, self.chroms, self.seq, self.planted, _ = make_genome(
            seed, config)
        self.work_per_unit = len(self.seq)
        self.info = {}
        self.outs: list[np.ndarray] = []

    def _run(self, genome) -> np.ndarray:
        from kit4b_tpu_torch.index.sfx_index import SfxIndex
        from kit4b_tpu_torch.kmer import hammings
        idx = SfxIndex.build(genome)
        return hammings.hammings_restricted(
            idx, self.K, max_hamming=self.r, antisense=self.antisense,
            device=self.device)

    def prepare(self) -> None:
        self.genome = _genome(self.names, self.chroms)
        self._run(_genome(self.names[:1], self.chroms[:1]))

    def unit(self, i: int) -> None:
        self.outs.append(self._run(self.genome))

    def free(self) -> None:
        self.genome = None

    def sample(self) -> tuple[np.ndarray, np.ndarray]:
        """(clean window starts, starts of windows with more than 4 Ns)."""
        seq, K = self.seq, self.K
        nk = len(seq) - K + 1
        isn = np.concatenate([[0], np.cumsum(seq >= 4)])
        n_in = isn[K:nk + K] - isn[:nk]
        pos = sample_positions(self.seed, seq, self.planted,
                               *self.check_n[:2], tag=31)
        pos = pos[(pos < nk)]
        clean = pos[n_in[pos] == 0]
        many = np.nonzero(n_in > 4)[0]
        rng = np.random.default_rng([self.seed, 32])
        many = rng.choice(many, min(self.check_n[2], len(many)),
                          replace=False) if len(many) else many
        return clean, many

    def lut_k(self) -> int:
        return ref.pick_lut_k(len(self.seq))

    def reference(self, clean: np.ndarray, control: bool = False):
        """The true minimum at the clean windows; the control drops the
        reverse strand (a guarantee the configuration states) and caps it
        as the mode does, standing in for the program's answers."""
        true = ref.restricted_true(self.seq, self.K, clean,
                                   self.antisense and not control,
                                   self.device)
        return np.minimum(true, self.r + 1) if control else true

    def check(self) -> dict:
        clean, many = self.sample()
        first = self.outs[0]
        if len(first) != len(self.seq):
            first = np.full(len(self.seq), ref.BIG, np.uint16)
        ok = ref.restricted_rule(first[clean].astype(np.int64),
                                 self.reference(clean), self.K, self.r,
                                 self.lut_k())
        return {
            "distances_length_wrong": (abs(len(self.outs[0])
                                           - len(self.seq)), 0),
            "units_differing": (sum(not np.array_equal(o, first)
                                    for o in self.outs[1:]), 0),
            "sampled_windows_breaking_rule": (int((~ok).sum()), 0),
            "n_windows_not_zero": (int((first[many] != 0).sum()), 0),
        }

    def control(self) -> dict:
        clean, _ = self.sample()
        ok = ref.restricted_rule(self.reference(clean, control=True),
                                 self.reference(clean), self.K, self.r,
                                 self.lut_k())
        return {"sampled_windows_breaking_rule": (int((~ok).sum()), 0)}
