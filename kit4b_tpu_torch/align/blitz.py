"""blitz's seeding, the part of kit4b_tpu/align/blitz.py that the PacBio
tools use (`ecreads._candidates`): query K-mers at a stride looked up in a
suffix index's bucket table (CBlitz's seed stage, libkit4b/CBlitz.cpp:341).
Host numpy, copied as it is; the chaining, the gapped refinement and the
`blitz` command are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..index.sfx_index import SfxIndex


def _seed_hits(index: SfxIndex, q: np.ndarray, stride: int,
               max_per_seed: int = 16):
    """Seed positions (qpos, tpos) for one query strand via the LUT."""
    k = index.lut_k
    L = len(q)
    if L < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.arange(0, L - k + 1, stride)
    w = q[starts[:, None] + np.arange(k)]
    ok = (w < 4).all(axis=1)
    pow4 = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    keys = (w.astype(np.int64) * pow4).sum(axis=1)
    lo = index.lut[keys]
    hi = np.minimum(index.lut[keys + 1], lo + max_per_seed)
    qps, tps = [], []
    for s, a, b, good in zip(starts, lo, hi, ok):
        if not good or b <= a:
            continue
        t = index.sa_clean[a:b]
        qps.extend([s] * len(t))
        tps.extend(t.tolist())
    return np.asarray(qps, np.int64), np.asarray(tps, np.int64)
