"""UCSC WIG coverage writer: the port's copy of kit4b_tpu/io/wig.py.

Reference: kalign's AccumWIGCnts/CompleteWIGSpan coverage output
(ngskit4b/KAligner.cpp:7004-7097); one variableStep span per run of equal,
non-zero coverage.
"""
from __future__ import annotations

import numpy as np


def write_wig(path, genome, coverage: np.ndarray, track_name: str = "coverage",
              ) -> None:
    """coverage: per concatenated-genome-position counts (uint32)."""
    with open(path, "w") as f:
        f.write(f'track type=wiggle_0 name="{track_name}"\n')
        for ci, name in enumerate(genome.names):
            s = int(genome.starts[ci])
            ln = int(genome.lengths[ci])
            cov = np.asarray(coverage[s:s + ln])
            if not cov.any():
                continue
            # run-length encode equal-coverage spans
            change = np.nonzero(np.diff(cov))[0]
            starts = np.concatenate([[0], change + 1])
            ends = np.concatenate([change + 1, [ln]])
            for a, b in zip(starts, ends):
                v = int(cov[a])
                if v == 0:
                    continue
                f.write(f"variableStep chrom={name} span={b - a}\n")
                f.write(f"{a + 1}\t{v}\n")
