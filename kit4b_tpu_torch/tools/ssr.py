"""ssr: simple-sequence-repeat (microsatellite) discovery, the port's copy of
kit4b_tpu/tools/ssr.py (host only; tests/test_torch_rehomed.py holds it
equal to the original statement for statement): for each unit length u,
maximal runs of seq[i] == seq[i+u] give tandem regions, units that are
themselves tandems of a shorter period left out.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna


@dataclass
class SSR:
    chrom: str
    start: int          # 0-based
    end: int            # exclusive
    unit_len: int
    repeats: int
    unit: str


def find_ssrs(genome, *, min_unit: int = 2, max_unit: int = 5,
              min_repeats: int = 5, max_repeats: int = 1000) -> list[SSR]:
    out: list[SSR] = []
    for ci, name in enumerate(genome.names):
        s = int(genome.starts[ci])
        ln = int(genome.lengths[ci])
        seq = np.asarray(genome.seq[s: s + ln])
        ok = seq < 4
        for u in range(min_unit, max_unit + 1):
            if ln <= u:
                continue
            eq = (seq[:-u] == seq[u:]) & ok[:-u] & ok[u:]
            # maximal runs of eq
            d = np.diff(np.concatenate([[0], eq.astype(np.int8), [0]]))
            starts = np.nonzero(d == 1)[0]
            ends = np.nonzero(d == -1)[0]
            for a, b in zip(starts, ends):
                m = b - a
                reps = (m + u) // u
                if not (min_repeats <= reps <= max_repeats):
                    continue
                # suppress period-u reports of shorter-period repeats
                # (e.g. AAAA... would match every u): require the unit not
                # itself be a tandem of a smaller period
                unit = seq[a: a + u]
                if any(u % p == 0 and (unit[:p] == unit.reshape(-1, p)).all()
                       for p in range(1, u) if u % p == 0):
                    continue
                out.append(SSR(name, a, a + reps * u, u, reps,
                               dna.decode(unit)))
    out.sort(key=lambda r: (r.chrom, r.start))
    return out


def write_ssrs_csv(path, ssrs: list[SSR]) -> None:
    with open(path, "w") as f:
        f.write('"SSR_ID","Chrom","Start","End","RepElLen","Tandems",'
                '"RepEl"\n')
        for i, r in enumerate(ssrs, 1):
            f.write(f'{i},"{r.chrom}",{r.start},{r.end},{r.unit_len},'
                    f'{r.repeats},"{r.unit}"\n')


def write_ssrs_bed(path, ssrs: list[SSR]) -> None:
    with open(path, "w") as f:
        for r in ssrs:
            f.write(f"{r.chrom}\t{r.start}\t{r.end}\t{r.unit}x{r.repeats}"
                    f"\t{min(r.repeats * 100, 1000)}\t+\n")
