"""Job `hammings_node`: one node's share of the exhaustive genome-wide
minimum K-mer Hamming distances (`hammings -K <K> -n <N> -N <n>`).

One unit is one call of `kmer/hammings.py` `hammings_exhaustive` on the
genome's codes, as the CLI's `sweep` phase makes it: a node engine
(`kmer/hammings_mxu.py` `HammingsNode`) uploads the codes and builds the
one-hot of the node's partner span for both strands, then all Gp own rows
run as one block: their one-hot built on the device, one launch of the
max-match kernel a strand (`kernels/minmm.py` -> `csrc/minmm.cu`), the
maxima folded to distances on the card and copied to the host. Set-up
makes the genome and runs the same call with the node's share cut to one
partner span, which builds and loads the kernel and allocates every
tensor of the timed shapes.

The check: every unit returned the first unit's distances; on positions
drawn from the seed (uniform over the genome, and inside the planted
near-copies) the first unit's distances equal the plain reference's.
"""
from __future__ import annotations

import numpy as np

from .. import recipes
from ..reference import hammings as ref

SPANS = [
    ("kit4b_tpu_torch.kmer.hammings_mxu", "build_w", "hammings.build_w"),
    ("kit4b_tpu_torch.kmer.hammings_mxu", "minmm", "hammings.minmm"),
    ("kit4b_tpu_torch.kmer.hammings", "hammings_exhaustive",
     "hammings.node"),
]


def make_genome(seed: int, config: dict):
    """(concatenated codes, planted (start, len) in them, chromosome
    starts) of the configuration's genome."""
    names, chroms, planted = recipes.genome(seed, config["genome"])
    seq = recipes.concat(chroms)
    starts = np.cumsum([0] + [len(c) + 1 for c in chroms[:-1]])
    return names, chroms, seq, [(int(starts[c]) + d, L)
                                for c, d, L in planted], starts


def sample_positions(seed: int, seq: np.ndarray, planted, n_random: int,
                     n_planted: int, tag: int) -> np.ndarray:
    """Positions drawn from the seed: uniform over the genome's window
    starts, and inside the planted copies in turn."""
    rng = np.random.default_rng([seed, tag])
    pos = [rng.integers(0, len(seq), n_random)]
    for i in range(n_planted):
        s, L = planted[i % len(planted)]
        pos.append([s + int(rng.integers(0, L))])
    return np.concatenate(pos).astype(np.int64)


class Job:
    """The genome of one run; `unit` is one sweep of the node's share."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tmpdir: str):
        self.seed, self.device = seed, device
        self.K = int(config["K"])
        self.antisense = bool(config["antisense"])
        self.node = int(traffic["node"]) - 1
        self.numnodes = int(traffic["numnodes"])
        self.check_n = (int(traffic["check_random"]),
                        int(traffic["check_planted"]))
        _, _, self.seq, self.planted, _ = make_genome(seed, config)
        self.work_per_unit = len(self.seq)
        from ..roofline import hammings_node_shape
        self.info = {"minmm": hammings_node_shape(
            len(self.seq), self.K, self.node, self.numnodes,
            self.antisense)}
        self.outs: list[np.ndarray] = []

    def prepare(self) -> None:
        from kit4b_tpu_torch.kmer import hammings
        n_spans = self.info["minmm"]["rows"] // 1024
        hammings.hammings_exhaustive(self.seq, self.K,
                                     antisense=self.antisense, node=0,
                                     numnodes=n_spans, device=self.device)

    def unit(self, i: int) -> None:
        from kit4b_tpu_torch.kmer import hammings
        self.outs.append(hammings.hammings_exhaustive(
            self.seq, self.K, antisense=self.antisense, node=self.node,
            numnodes=self.numnodes, device=self.device))

    def free(self) -> None:
        """Nothing of the program outlives a unit on the device."""

    def sample(self) -> np.ndarray:
        return sample_positions(self.seed, self.seq, self.planted,
                                *self.check_n, tag=21)

    def reference(self, pos: np.ndarray, control: bool = False):
        """The reference's node partial; the control drops the reverse
        strand (half the partners, a guarantee the configuration states)."""
        return ref.node_min(self.seq, self.K, pos, self.node, self.numnodes,
                            self.antisense and not control, self.device)

    def check(self) -> dict:
        pos = self.sample()
        first = self.outs[0]
        if len(first) != len(self.seq):
            first = np.full(len(self.seq), ref.BIG, np.uint16)
        return {
            "distances_length_wrong": (abs(len(self.outs[0])
                                           - len(self.seq)), 0),
            "units_differing": (sum(not np.array_equal(o, first)
                                    for o in self.outs[1:]), 0),
            "sampled_positions_differing": (int(
                (first[pos] != self.reference(pos)).sum()), 0),
        }

    def control(self) -> dict:
        pos = self.sample()
        return {"sampled_positions_differing": (int(
            (self.reference(pos, control=True)
             != self.reference(pos)).sum()), 0)}
