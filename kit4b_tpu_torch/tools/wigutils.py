"""wigutils: WIG coverage-file utilities, the port's copy of
kit4b_tpu/tools/wigutils.py (host only; tests/test_torch_rehomed.py holds
it equal to the original statement for statement): read fixedStep and
variableStep tracks, merge several (sum, mean, min, max), per-chromosome
statistics, and re-emit run-length fixedStep or CSV.
"""
from __future__ import annotations

import numpy as np


def read_wig(path) -> dict[str, dict[int, float]]:
    """Sparse per-chrom position->value map (0-based positions)."""
    out: dict[str, dict[int, float]] = {}
    chrom, pos, step, span, mode = None, 0, 1, 1, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("track", "#", "browser")):
                continue
            if line.startswith("fixedStep") or line.startswith(
                    "variableStep"):
                kv = dict(p.split("=") for p in line.split()[1:])
                chrom = kv["chrom"]
                span = int(kv.get("span", 1))
                step = int(kv.get("step", 1))
                pos = int(kv.get("start", 1)) - 1
                mode = line.split()[0]
                out.setdefault(chrom, {})
                continue
            d = out[chrom]
            if mode == "fixedStep":
                v = float(line)
                for s in range(span):
                    d[pos + s] = v
                pos += step
            else:
                p, v = line.split()
                p = int(p) - 1
                for s in range(span):
                    d[p + s] = float(v)
    return out


def merge_wigs(tracks: list[dict], op: str = "sum") -> dict:
    """Elementwise merge of sparse tracks; absent positions count as 0 for
    sum/mean/max and are skipped for min."""
    out: dict[str, dict[int, float]] = {}
    chroms = set()
    for t in tracks:
        chroms.update(t)
    for c in chroms:
        acc: dict[int, list[float]] = {}
        for t in tracks:
            for p, v in t.get(c, {}).items():
                acc.setdefault(p, []).append(v)
        d = {}
        for p, vs in acc.items():
            if op == "sum":
                d[p] = sum(vs)
            elif op == "mean":
                d[p] = sum(vs) / len(tracks)
            elif op == "max":
                d[p] = max(vs)
            elif op == "min":
                d[p] = min(vs) if len(vs) == len(tracks) else 0.0
            else:
                raise ValueError(op)
        out[c] = d
    return out


def wig_stats(track: dict) -> list[dict]:
    rows = []
    for c in sorted(track):
        v = np.array(list(track[c].values()), float)
        if not len(v):
            continue
        rows.append({"chrom": c, "covered": len(v), "sum": float(v.sum()),
                     "mean": float(v.mean()), "max": float(v.max()),
                     "min": float(v.min())})
    return rows


def write_wig_sparse(path, track: dict, name: str = "wigutils") -> None:
    """Run-length fixedStep emission of a sparse track."""
    with open(path, "w") as f:
        f.write(f'track type=wiggle_0 name="{name}"\n')
        for c in sorted(track):
            items = sorted(track[c].items())
            i = 0
            while i < len(items):
                j = i
                while (j + 1 < len(items)
                       and items[j + 1][0] == items[j][0] + 1
                       and items[j + 1][1] == items[i][1]):
                    j += 1
                span = items[j][0] - items[i][0] + 1
                f.write(f"fixedStep chrom={c} start={items[i][0]+1} "
                        f"step=1 span={span}\n")
                v = items[i][1]
                f.write(f"{int(v) if v == int(v) else v}\n")
                i = j + 1


def write_wig_csv(path, track: dict) -> None:
    with open(path, "w") as f:
        f.write('"Chrom","Pos","Value"\n')
        for c in sorted(track):
            for p, v in sorted(track[c].items()):
                f.write(f'"{c}",{p},{v:g}\n')
