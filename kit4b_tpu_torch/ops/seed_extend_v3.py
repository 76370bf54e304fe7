"""Classification and the compact [B, 2] result of the kalign tier-1 pass.

Port of `make_lut2_device`, `_classify_compact`, `pack_result2` and
`unpack_result2` from kit4b_tpu/ops/seed_extend_v3.py. The v3 passes
themselves (`fast_pass_compact_v3`, `fast_pass_v3`, `fast_pass_packed_v3`)
are not ported: v4 supersedes them on this path, and the others serve the
rescues and the genomes past 1.07 Gbp (ROADMAP queue A item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from .seed_extend_fast import INT32_MAX


def make_lut2_device(lut: torch.Tensor) -> torch.Tensor:
    """[n_keys, 2] int32 (bucket_lo, bucket_cnt) pair table, so one
    row-gather resolves a seed window; built on the lut's device."""
    if int(lut[-1]) >= 2 ** 31:
        raise ValueError("suffix count must fit int32")
    lut32 = lut.to(torch.int32)
    return torch.stack([lut32[:-1], lut32[1:] - lut32[:-1]], dim=1)


def _classify_compact(ids, mm, overflow, *, max_tot_mm, mm_delta):
    """[NS, B] candidate stats -> (code, low, n_low) each [B] int32."""
    ok = ids != INT32_MAX
    low = mm.amin(0)
    n_low = ((mm == low[None, :]) & ok).sum(0, dtype=torch.int32)
    nxt = torch.where(mm > low[None, :], mm, INT32_MAX).amin(0)
    best_id = torch.where(mm == low[None, :], ids, INT32_MAX).amin(0)
    aligned = low <= max_tot_mm
    unique = (aligned & ~overflow & (n_low == 1)
              & ((nxt - low) >= mm_delta))
    code = torch.where(overflow, -3,
                       torch.where(unique, best_id,
                                   torch.where(aligned, -2, -1)))
    return code.to(torch.int32), low, n_low


def pack_result2(code, low):
    """(code, low) -> [B, 2] int32 compact result: col 0 = code
    (pos*2+strand when accepted, else -1 nohit / -2 multi / -3 overflow),
    col 1 = lowest mismatch count (INT32_MAX when no candidate scored).
    Valid while 2*genome_len + 1 < 2^31."""
    return torch.stack([code, low], dim=1)


def unpack_result2(res: np.ndarray):
    """Host-side inverse of pack_result2 -> (code, low, n_low); n_low is
    reduced to its class (1 accepted, >=2 multi, 0 otherwise)."""
    res = np.asarray(res)
    code = res[:, 0].astype(np.int64)
    low = res[:, 1].astype(np.int64)
    n_low = np.where(code >= 0, 1, np.where(code == -2, 2, 0))
    return code, low, n_low
