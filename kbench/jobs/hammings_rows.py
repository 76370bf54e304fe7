"""Job `hammings_rows`: one node's exhaustive minimum K-mer Hamming
distances (`hammings -K <K> -n <N> -N <n>`) on a genome too large to hold
its one-hot windows, own rows streamed in blocks.

Set-up makes the genome, plants near-copies of the node's partner span,
prepares the program's node engine (`kmer/hammings_mxu.py`
`HammingsNode`: the genome's codes on the card and the partner one-hot of
the node's span, both strands) and warms it on one small block. One unit
is one block of `unit_rows` own rows, unit i starting at row `first_row +
(i mod n) * unit_rows` (n blocks fit before the padded genome's end):
the block's one-hot built from the codes, one max-match launch a strand
(`kernels/minmm.py` -> `csrc/minmm.cu`), the maxima collected and folded.

The job plants its own near-copies: for each of the first `copy_units`
units, a segment of the node's partner span on the sense strand and one
on the reverse complement's, each `copy_len` with `copy_subs`
substitutions, copied into the unit's rows, so that distances of a few
occur on both strands where the run checks.

The check, on positions drawn from the seed: `check_random` in each unit
the window ran, `check_self` among the rows that ran whose own column is
in the node's span (the self pairs), and `check_copies` inside the
planted copies that ran, each equal to the plain reference; a unit that
ran a block again equals its first run.
"""
from __future__ import annotations

import numpy as np

from .. import recipes
from ..reference import hammings_rows as ref

SPANS = [
    ("kit4b_tpu_torch.kmer.hammings_mxu", "HammingsNode.rows",
     "hammings.block"),
    ("kit4b_tpu_torch.kmer.hammings_mxu", "minmm", "hammings.minmm"),
]
WARM_ROWS = 1 << 16
TRIES = 1000      # draws of a copy's source or place before giving up


def intervals_hit(a: int, b: int, taken) -> bool:
    return any(a < e and s < b for s, e in taken)


def plant_node_copies(seq: np.ndarray, seed: int, cols: tuple[int, int],
                      slots: list[tuple[int, int]], L: int, subs: int,
                      K: int) -> list[tuple[int, int, bool]]:
    """Near-copies of the node's partner span into the rows of `slots`,
    in place: two a slot, a sense segment of columns `cols` and one of the
    reverse complement's, `subs` substitutions each, neither over a
    separator nor over the span's text of either strand nor over another
    copy. Returns [(start, length, sense)]."""
    rng = np.random.default_rng([seed, 23])
    G = len(seq)
    c0, c1 = cols
    taken = [(c0 - L, c1 + K), (G - c1 - K, G - c0 + 1)]
    planted = []
    for lo, hi in slots:
        for sense in (True, False):
            codes_of = ref.sense_codes if sense else ref.antisense_codes
            for _ in range(TRIES):
                s = int(rng.integers(c0, c1 - L))
                seg = codes_of(seq, s, s + L)
                if (seg < ref.SENTINEL).all():
                    break
            else:
                raise ValueError("no segment of the span without a separator")
            pick = rng.choice(L, subs, replace=False)
            seg[pick] = (seg[pick] + rng.integers(1, 4, subs)) % 4
            for _ in range(TRIES):
                d = int(rng.integers(lo, hi - L))
                if not intervals_hit(d, d + L, taken) \
                        and (seq[d:d + L] < ref.SENTINEL).all():
                    break
            else:
                raise ValueError(f"no room for a copy in rows [{lo}, {hi})")
            seq[d:d + L] = seg
            taken.append((d, d + L))
            planted.append((d, L, sense))
    return planted


class Job:
    """The genome of one run and the node's engine; `unit` is one block
    of own rows."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tmpdir: str):
        # a program without the streamed node engine fails here, at once
        from kit4b_tpu_torch.kmer.hammings_mxu import HammingsNode
        self._engine_of = HammingsNode
        self.seed, self.device = seed, device
        self.K = int(config["K"])
        self.antisense = bool(config["antisense"])
        self.node = int(traffic["node"]) - 1
        self.numnodes = int(traffic["numnodes"])
        self.first = int(traffic["first_row"])
        self.unit_rows = int(traffic["unit_rows"])
        self.check_n = (int(traffic["check_random"]),
                        int(traffic["check_self"]),
                        int(traffic["check_copies"]))
        _, chroms, _ = recipes.genome(seed, config["genome"])
        self.seq = recipes.concat(chroms)
        del chroms
        self.Gp, self.c0, self.c1 = ref.node_columns(
            len(self.seq), self.node, self.numnodes)
        self.n_slots = (self.Gp - self.first) // self.unit_rows
        if self.n_slots < 1:
            raise ValueError("no own-row block fits after first_row")
        gen = config["genome"]
        copy_slots = [self.slot_rows(u) for u in
                      range(min(int(traffic["copy_units"]), self.n_slots))]
        self.copies = plant_node_copies(
            self.seq, seed, (self.c0, self.c1), copy_slots,
            int(gen["copy_len"]), int(gen["copy_subs"]), self.K)
        self.work_per_unit = self.unit_rows
        self.info = {"minmm": {"rows": self.unit_rows,
                               "cols": self.c1 - self.c0,
                               "K": self.K,
                               "strands": 2 if self.antisense else 1}}
        self.engine = None
        self.outs: list[np.ndarray] = []

    def slot_rows(self, u: int) -> tuple[int, int]:
        r0 = self.first + u * self.unit_rows
        return r0, r0 + self.unit_rows

    def prepare(self) -> None:
        self.engine = self._engine_of(
            self.seq, self.K, antisense=self.antisense, node=self.node,
            numnodes=self.numnodes, device=self.device)
        self.engine.rows(self.c0, min(self.c0 + WARM_ROWS, self.Gp,
                                      self.c0 + self.unit_rows))

    def unit(self, i: int) -> None:
        self.outs.append(self.engine.rows(
            *self.slot_rows(i % self.n_slots)))

    def free(self) -> None:
        """The engine's codes and partner windows leave the device."""
        self.engine = None

    def sample(self, slots) -> dict[str, np.ndarray]:
        """Positions drawn from the seed in the rows of `slots`."""
        n_random, n_self, n_copies = self.check_n
        rng = np.random.default_rng([self.seed, 31])
        rows = [self.slot_rows(u) for u in sorted(slots)]
        random = [rng.integers(a, b, n_random) for a, b in rows]
        self_iv = [(max(a, self.c0), min(b, self.c1)) for a, b in rows]
        self_iv = [(a, b) for a, b in self_iv if a < b]
        pos = {"random": np.concatenate(random)}
        if self_iv:
            size = np.array([b - a for a, b in self_iv])
            k = rng.choice(len(self_iv), n_self, p=size / size.sum())
            pos["self"] = np.array([self_iv[j][0] for j in k]) \
                + (rng.random(n_self) * size[k]).astype(np.int64)
        copies = [c for c in self.copies
                  if any(a <= c[0] < b for a, b in rows)]
        if copies:
            k = rng.integers(0, len(copies), n_copies)
            pos["copies"] = np.array([copies[j][0] for j in k]) \
                + rng.integers(0, copies[0][1], n_copies)
        return {k: v.astype(np.int64) for k, v in pos.items()}

    def reference(self, pos: np.ndarray, control: bool = False):
        """The reference's node partial; the control drops the reverse
        strand (half the partners, a guarantee the configuration states)."""
        return ref.node_rows_min(self.seq, self.K, pos, self.node,
                                 self.numnodes,
                                 self.antisense and not control, self.device)

    def check(self) -> dict:
        first: dict[int, np.ndarray] = {}
        repeated = 0
        for i, o in enumerate(self.outs):
            u = i % self.n_slots
            if u in first:
                repeated += not np.array_equal(o, first[u])
            else:
                first[u] = o
        wrong = sum(len(o) != self.unit_rows for o in self.outs)
        out = {"blocks_length_wrong": (wrong, 0),
               "blocks_run_again_differing": (repeated, 0)}
        for kind, pos in self.sample(first).items():
            got = np.full(len(pos), ref.BIG, np.uint16)
            for u, o in first.items():
                a, _ = self.slot_rows(u)
                inside = (pos >= a) & (pos - a < len(o))
                got[inside] = o[pos[inside] - a]
            diff = int((got != self.reference(pos)).sum())
            out[f"{kind}_rows_differing"] = (diff, 0)
        return out

    def control(self) -> dict:
        slots = range(min(4, self.n_slots))
        return {f"{kind}_rows_differing": (int(
            (self.reference(pos, control=True)
             != self.reference(pos)).sum()), 0)
            for kind, pos in self.sample(slots).items()}
