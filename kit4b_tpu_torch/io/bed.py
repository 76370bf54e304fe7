"""BED features for `simreads -t` and `kalign -B`: the port's copy of
`BedFeature`, `BedFile.load` and `BedFile.overlapping` from
kit4b_tpu/io/bed.py. A parsed feature table with, per chromosome, the
features sorted by start and the running maximum of their ends, so an
overlap query is one searchsorted and a short walk back."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BedFeature:
    chrom: str
    start: int       # 0-based
    end: int         # exclusive
    name: str = ""
    score: int = 0
    strand: str = "+"


class BedFile:
    def __init__(self, features: list[BedFeature]):
        self.features = features
        self._by_chrom: dict[str, tuple] = {}
        per: dict[str, list[int]] = {}
        for i, f in enumerate(features):
            per.setdefault(f.chrom, []).append(i)
        for chrom, idxs in per.items():
            idxs.sort(key=lambda i: features[i].start)
            starts = np.asarray([features[i].start for i in idxs], np.int64)
            ends = np.asarray([features[i].end for i in idxs], np.int64)
            # running max of ends enables overlap search on sorted starts
            maxend = np.maximum.accumulate(ends)
            self._by_chrom[chrom] = (starts, ends, maxend,
                                     np.asarray(idxs, np.int64))

    @classmethod
    def load(cls, path) -> "BedFile":
        feats: list[BedFeature] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if (not line or line.startswith("#")
                        or line.startswith("track")
                        or line.startswith("browser")):
                    continue
                c = line.split("\t")
                if len(c) < 3:
                    c = line.split()
                feats.append(BedFeature(
                    c[0], int(c[1]), int(c[2]),
                    c[3] if len(c) > 3 else "",
                    int(float(c[4])) if len(c) > 4 and c[4] != "." else 0,
                    c[5] if len(c) > 5 else "+"))
        return cls(feats)

    def overlapping(self, chrom: str, start: int, end: int
                    ) -> list[BedFeature]:
        """Features overlapping [start, end)."""
        entry = self._by_chrom.get(chrom)
        if entry is None:
            return []
        starts, ends, maxend, idxs = entry
        hi = int(np.searchsorted(starts, end, side="left"))
        out = []
        # walk back while any running max end can still overlap
        for j in range(hi - 1, -1, -1):
            if maxend[j] <= start:
                break
            if ends[j] > start:
                out.append(self.features[int(idxs[j])])
        out.reverse()
        return out

    def __len__(self) -> int:
        return len(self.features)
