"""genmlds + sarscov2ml: ML dataset generation and feature-linkage
discovery.

Capability parity with `ngskit4b genmlds` (ngskit4b/CGenMLdatasets.cpp
CGenMLdatasets: transpose a feature x sample CSV into an ML-ready
sample x feature matrix with optional sample-label association) and
`ngskit4b sarscov2ml` (ngskit4b/sarscov2ml.cpp CSarsCov2ML mode 0:
discover linkages — sets of feature columns whose class values
co-occur at or above a threshold in at least MinLinkedRows rows).

The port's copy of kit4b_tpu/tools/mlds.py. The pairwise co-occurrence
count used for linkage seeding is one float32 matmul of 0/1 values
([R, F]^T @ [R, F]) on an explicit device, as in the JAX package (no
Pallas kernel: `torch.matmul`).
"""
from __future__ import annotations

import csv

import numpy as np
import torch

from ..device import resolve


def transpose_dataset(in_path, out_path, labels: dict | None = None,
                      label_name: str = "Label") -> tuple[int, int]:
    """genmlds default mode: feature-rows x sample-columns CSV ->
    sample-rows x feature-columns CSV, prepending an optional label
    column (CGenMLdatasets AssociateSampleLabels)."""
    with open(in_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, data = rows[0], rows[1:]
    samples = [h.strip().strip('"') for h in header[1:]]
    features = [r[0].strip().strip('"') for r in data]
    with open(out_path, "w") as f:
        cols = ['"Sample"']
        if labels is not None:
            cols.append(f'"{label_name}"')
        cols += [f'"{ft}"' for ft in features]
        f.write(",".join(cols) + "\n")
        for si, s in enumerate(samples):
            vals = [f'"{s}"']
            if labels is not None:
                vals.append(f'"{labels.get(s, "")}"')
            vals += [r[1 + si] for r in data]
            f.write(",".join(vals) + "\n")
    return len(samples), len(features)


def load_sample_labels(path) -> dict:
    out = {}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) >= 2:
                out[row[0].strip().strip('"')] = row[1].strip().strip('"')
    return out


def find_feature_linkages(matrix: np.ndarray, feat_names: list,
                          num_linked: int = 5, min_rows: int = 50,
                          min_class: int = 3,
                          device="cuda") -> list[dict]:
    """sarscov2ml mode 0: find groups of `num_linked` features whose
    values are all >= min_class in at least min_rows common rows.

    matrix: [rows(samples/isolates), features] int values. Seeds from
    the pairwise co-support matrix (a matmul on `device`), then greedily
    grows each seed column by the feature maximising remaining co-support.
    """

    hot = matrix >= min_class                        # [R, F] bool
    support = hot.sum(axis=0)
    keep = np.nonzero(support >= min_rows)[0]
    if len(keep) < num_linked:
        return []
    # float32 sums of 0/1 values are exact while R < 2^24 rows, in any
    # summation order, so below that the counts equal the JAX package's
    h = torch.from_numpy(hot[:, keep].astype(np.float32)).to(resolve(device))
    co = (h.T @ h).cpu().numpy().astype(np.int64)   # [K, K] co-support
    out, seen = [], set()
    order = np.argsort(-np.diag(co))
    for si in order:
        members = [si]
        rows = hot[:, keep[si]].copy()
        # scan candidates in descending pairwise co-support with the
        # seed — high co-support columns are the likely linkage members
        cand_order = np.argsort(-co[si])
        while len(members) < num_linked:
            best, best_n = -1, min_rows - 1
            for cj in cand_order:
                if cj in members or co[si, cj] < min_rows:
                    continue
                n = int(np.count_nonzero(rows & hot[:, keep[cj]]))
                if n > best_n:
                    best, best_n = cj, n
            if best < 0:
                break
            members.append(best)
            rows &= hot[:, keep[best]]
        if len(members) < num_linked:
            continue
        n_common = int(np.count_nonzero(rows))
        if n_common < min_rows:
            continue
        key = tuple(sorted(keep[m] for m in members))
        if key in seen:
            continue
        seen.add(key)
        out.append({"features": [feat_names[keep[m]] for m in members],
                    "rows": n_common})
    out.sort(key=lambda d: -d["rows"])
    return out


def write_linkages_csv(path, linkages: list) -> None:
    with open(path, "w") as f:
        f.write('"LinkedRows","Features"\n')
        for lk in linkages:
            f.write(f'{lk["rows"]},"' + ";".join(lk["features"]) + '"\n')
