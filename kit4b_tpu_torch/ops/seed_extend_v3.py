"""Classification, the compact [B, 2] result of the kalign tier-1 pass,
and the full-stats tier 1.

Port of `make_lut2_device`, `_classify_compact`, `pack_result2`,
`unpack_result2` and `fast_pass_v3` from kit4b_tpu/ops/seed_extend_v3.py.
`fast_pass_v3` runs on the v4 core (see its docstring). Not ported:
`fast_pass_packed_v3` (v4 and v5 supersede it), and
`fast_pass_compact_v3`, which serves genomes with 2*G+1 >= 2^31, whose
int32 locus ids wrap (ROADMAP queue A item 18).
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


def fast_pass_v3(gview, sa, lut2, reads2b, nlist, *, genome_len, offsets,
                 lut_k, read_len, n_compact, max_ml, n_extend=None,
                 max_per_bucket=None):
    """Full-stats tier 1: 2-bit reads in, fast_pass's dict out (low_mm /
    n_low / nxt_mm [B], hit_id / hit_mm [B, max_ml], overflow [B]); the
    hit lists feed the microInDel, splice and chimeric rescues and the
    pairing of mates of unequal length.

    JAX's `fast_pass_v3` runs `_cands_core` on lane-major byte tensors, a
    layout chosen for two TPU cost laws. The v4 core keeps that core's
    exact contract (the same distinct loci, mismatch counts and overflow)
    from packed word planes, so this pass is `words_from_2bit` ->
    `_cands_core_v4` -> `finalize_fast`, and reads cross to the device at
    2 bits a base. JAX's `key_lo` (the key-sharded index) is the v4
    core's `key_lo`, which `parallel.mesh.make_sharded_align_pass_v3`
    passes. Not taken from JAX: `single_strand`, `lut_base`, `digit_map`,
    which no caller of JAX's v3 core passes (the bisulfite pass runs
    `seed_extend_fast.fast_candidates`). Nothing here waits for the
    device."""
    from .seed_extend_fast import finalize_fast
    from .seed_extend_v4 import _cands_core_v4, words_from_2bit
    planes = words_from_2bit(reads2b, nlist, read_len)
    ids, mm, overflow = _cands_core_v4(
        gview, sa, lut2, planes, genome_len=genome_len, offsets=offsets,
        lut_k=lut_k, read_len=read_len, n_compact=n_compact,
        n_extend=n_extend, max_per_bucket=max_per_bucket)
    out = finalize_fast(ids.T, mm.T, max_ml=max_ml)
    out["overflow"] = overflow
    return out
