"""rnaexpr: RNA expression matrix replicate-consistency analysis.

Capability parity with `ngskit4b rnaexpr` mode 0 (ngskit4b/rnaexpr.cpp
CRNAExpr::GenExprCntsPearsons): biological replicates are labeled in
pairs; for every sample compute the Pearson correlation of its
expression profile against every other sample, report the correlation
with its labeled partner vs the maximal correlation found, plus the
Fisher z-statistic for partner-vs-best. A replicate whose best match is
not its labeled partner is an inconsistency.

The port's copy of kit4b_tpu/align/rnaexpr.py. The all-pairs correlation
is one float32 matmul of the standardized count matrix, [S, F] @ [F, S],
on an explicit device, as the JAX package computes it (no Pallas kernel:
`torch.matmul`). It stays float32 throughout, and the port never enables
TF32 (tests/test_torch_rnaexpr_mlds.py checks that nothing sets it): a
TF32 product would round the inputs to 10 mantissa bits.
"""
from __future__ import annotations

import csv
import math

import numpy as np
import torch

from ..device import resolve


def load_counts_matrix(path):
    """Counts CSV: header = "Feature", sample names...; rows = feature,
    per-sample counts. Returns (samples, features, [F, S] float array)."""
    with open(path, newline="") as f:
        rdr = csv.reader(f)
        header = next(rdr)
        samples = [h.strip().strip('"') for h in header[1:]]
        features, data = [], []
        for row in rdr:
            if len(row) != len(header):
                continue
            features.append(row[0].strip().strip('"'))
            data.append([float(v) for v in row[1:]])
    return samples, features, np.asarray(data, np.float64)


def pearson_matrix(counts: np.ndarray, device="cuda") -> np.ndarray:
    """All-pairs sample Pearson correlations from a [F, S] counts
    matrix, as a single [S, S] float32 matmul on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(counts.T, np.float32)).to(
        resolve(device))                             # [S, F]
    x = x - x.mean(dim=1, keepdim=True)
    norm = torch.sqrt((x * x).sum(dim=1, keepdim=True))
    x = x / torch.clamp(norm, min=1e-12)
    r = x @ x.T
    return torch.clamp(r, -1.0, 1.0).cpu().numpy()  # host copy, writable


def _fisher_z(r: float, n: int) -> float:
    r = min(max(r, -0.999999), 0.999999)
    return 0.5 * math.log((1 + r) / (1 - r)) * math.sqrt(max(n - 3, 1))


def replicate_consistency(samples: list, counts: np.ndarray,
                          partners: dict | None = None,
                          device="cuda") -> list[dict]:
    """Per-sample partner-vs-best Pearson report.

    partners: sample -> its labeled replicate partner; defaults to the
    reference's adjacent pairing (rnaexpr.cpp:1143-1147: even/odd
    neighbours).
    """
    n_feat = counts.shape[0]
    r = pearson_matrix(counts, device)
    np.fill_diagonal(r, -2.0)
    out = []
    for i, s in enumerate(samples):
        if partners and s in partners:
            j = samples.index(partners[s])
        else:
            j = i + 1 if i % 2 == 0 else i - 1
        if not 0 <= j < len(samples):
            continue
        best = int(np.argmax(r[i]))
        r_part, r_best = float(r[i, j]), float(r[i, best])
        z = abs(_fisher_z(r_best, n_feat) - _fisher_z(r_part, n_feat)) \
            / math.sqrt(2.0)
        p = math.erfc(z / math.sqrt(2.0))
        out.append({
            "sample": s, "partner": samples[j],
            "partner_r": round(r_part, 6),
            "best": samples[best], "best_r": round(r_best, 6),
            "z": round(z, 4), "pvalue": round(p, 6),
            "consistent": best == j})
    return out


def write_consistency_csv(path, results: list) -> None:
    with open(path, "w") as f:
        f.write('"Sample","Partner","PartnerPearson","BestMatch",'
                '"BestPearson","Zobs","PValue","Consistent"\n')
        for r in results:
            f.write(f'"{r["sample"]}","{r["partner"]}",{r["partner_r"]},'
                    f'"{r["best"]}",{r["best_r"]},{r["z"]},'
                    f'{r["pvalue"]},{int(r["consistent"])}\n')
