"""BED features for `simreads -t`: the port's copy of `BedFeature` and
`BedFile.load` from kit4b_tpu/io/bed.py, kept to the feature list that
`simreads` reads (the interval queries serve paths not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass


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

    def __len__(self) -> int:
        return len(self.features)
