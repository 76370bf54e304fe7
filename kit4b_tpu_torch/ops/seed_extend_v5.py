"""kalign tier 1 (v5): the flattened seed index.

Port of kit4b_tpu/ops/seed_extend_v5.py. The bucket table `lut4` stores
each bucket's first P_POS = 7 suffix positions inline beside its count, so
one row gather per seed window replaces the pair-table gather and the
suffix-array gather of v4. Reads touching a bucket with more than P_POS
entries escalate (code -3) and rerun on the device through v4's tier 2
(`seed_extend_v4._tier2`); reads past its E slots keep -3 and resolve on
the host ladder of `align.kalign`.
"""
from __future__ import annotations

import numpy as np
import torch

from .seed_extend_fast import _shape_constants
from .seed_extend_v3 import _classify_compact, pack_result2
from .seed_extend_v4 import _compact, _dedup_extend, _seed_keys, \
    _slot_meta, _tier2, words_from_2bit

P_POS = 7   # suffix positions inlined per bucket (col 7 = cnt)


def make_lut4_device(lut: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """[n_keys, 8] int32 flattened bucket table on the device of lut/sa:
    cols 0..6 = the bucket's first 7 suffix positions (sa[lo..lo+6],
    clamped reads, masked by cnt downstream), col 7 = bucket count."""
    if int(lut[-1]) >= 2 ** 31:
        raise ValueError("suffix count must fit int32")
    lut32 = lut.to(torch.int32)
    lo = lut32[:-1].long()
    cnt = lut32[1:] - lut32[:-1]
    M = sa.shape[0]
    cols = [sa[(lo + p).clamp(0, M - 1)].to(torch.int32)
            for p in range(P_POS)]
    return torch.stack(cols + [cnt], dim=1)


def host_escalation_estimate(lut: np.ndarray, n_windows: int) -> float:
    """Upper-bound estimate of the per-read tier-1 escalation probability:
    a read escalates when ANY of its 2*n_windows seed buckets holds more
    than P_POS suffixes. Windows are approximated as independent draws
    weighted by bucket occupancy (true-locus windows) — a histogram-only
    host-side eligibility check, no device work."""
    cnt = np.diff(np.asarray(lut))
    total = int(cnt.sum())
    if total == 0:
        return 0.0
    frac_high = float(cnt[cnt > P_POS].sum()) / total
    return min(1.0, 2 * n_windows * frac_high)


def _cands_core_v5(gview, lut4, planes, *, genome_len, offsets, lut_k,
                   read_len, n_compact, n_extend=None):
    """Tier-1 seed + compact + locus-dedup + extend from the flattened
    bucket table. Same (ids, mm, overflow) contract as `_cands_core_v4`;
    overflow also holds every read with a seed bucket over P_POS."""
    nw, B = planes[0].shape
    L = read_len
    NC = n_compact
    W = len(offsets)
    D = 2 * W

    local, key_ok = _seed_keys(planes, offsets, lut_k, lut4.shape[0])
    row = lut4[local]                                       # [S, W, B, 8]
    cnt_raw = torch.where(key_ok, row[..., P_POS], 0)
    high = cnt_raw > P_POS
    cnt_d = cnt_raw.clamp(max=P_POS).reshape(D, B)
    posP = row[..., :P_POS].reshape(D, B, P_POS)            # [D, B, 7]

    total, b, rank, slot_ok = _compact(cnt_d, NC)
    overflow = (total > NC) | high.reshape(D, B).any(0)
    off_w = _shape_constants(tuple(offsets), lut_k, L, b.device).off_w
    w_d, strand, off_b = _slot_meta(b, off_w)
    # suffix position per slot without an SA gather: the slot's bucket row
    # of inline positions, then the entry at the slot's rank (0 past 7)
    sel = posP.gather(0, b[:, :, None].expand(-1, -1, P_POS))  # [NC, B, 7]
    at = sel.gather(2, rank.clamp(0, P_POS - 1).long()[:, :, None])[..., 0]
    sa_pos = torch.where((rank >= 0) & (rank < P_POS), at, 0)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= genome_len)
    return _dedup_extend(gview, planes, pos, strand, w_d, valid, overflow,
                         read_len=L, offsets=offsets, lut_k=lut_k,
                         n_extend=n_extend or NC)


def fast_pass_packed_v5(gview, sa, lut2, lut4, reads2b, nlist, *,
                        genome_len, offsets, lut_k, n_compact, max_tot_mm,
                        mm_delta, read_len, n_extend=None,
                        tier2=(256, 192, 96)):
    """Drop-in for fast_pass_packed_v4 with the flattened tier-1 index:
    2-bit reads in, [B, 2] int32 rows out. Tier 2 (bucket over P_POS,
    candidate-total or distinct-loci overflow) runs v4's pair-table + SA
    path on the device at the deeper caps.

    Equal to v4's rows for every read provided the escalated reads fit the
    E tier-2 slots; v5 escalates more reads than v4 (every bucket-high
    read), so past E the leftover reads return -3 and resolve through the
    caller's host ladder."""
    planes = words_from_2bit(reads2b, nlist, read_len)
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len)
    ids, mm, overflow = _cands_core_v5(gview, lut4, planes,
                                       n_compact=n_compact,
                                       n_extend=n_extend, **kw)
    code, low, _ = _classify_compact(ids, mm, overflow,
                                     max_tot_mm=max_tot_mm,
                                     mm_delta=mm_delta)
    if tier2 is not None:
        code, low = _tier2(code, low, planes, gview, sa, lut2, tier2,
                           max_tot_mm=max_tot_mm, mm_delta=mm_delta, **kw)
    return pack_result2(code, low)
