"""Paired-end tier 1: both mates' packed-native seed-extend, the pairing
cross-product and the in-graph escalation, on the device.

Port of kit4b_tpu/ops/pe_packed.py. Reads arrive 2-bit packed; each mate
runs the v4 candidate core (`seed_extend_v4._cands_core_v4`) and
`finalize_fast`'s top-max_ml hit lists; `_pair_rows` evaluates the
reference's AcceptProvPE cross-product over those hits (ngskit4b/
KAligner.cpp:10173-10238: opposite strands, one chromosome, the forward
mate leftmost, the outer insert within [min_ins, max_ins], the lowest
combined mismatch count wins and a tie on distinct loci rejects the pair)
and returns one [B, 12] int32 row per pair:

    0: best id1 (pos*2+strand)   4: tlen (outer insert)   8: mate1 low_mm
    1: best id2                  5: pair code (PAIR_*)    9: mate2 low_mm
    2: mm1                       6: mate1 side code      10: mate1 overflow
    3: mm2                       7: mate2 side code      11: mate2 overflow

Pairs whose tier-1 compaction overflowed re-run both mates at deeper
capacities in the same pass (tier 2: the first E such pairs of the batch;
tier 3, capped per bucket, when asked for). The result crosses to the host
as [B, 6] wire words (`pack_rows6`), or as the [B, 12] rows when max_ins
does not fit the 16-bit tlen field. Nothing here waits for the device: the
escalated pairs are found with a running count and `searchsorted`, never
with a host read of the count.
"""
from __future__ import annotations

import numpy as np
import torch

from .bits import scatter_set_drop
from .seed_extend_fast import INT32_MAX, finalize_fast
from .seed_extend_v4 import _cands_core_v4, words_from_2bit

PAIR_NONE = 0
PAIR_ACCEPT = 1
PAIR_MULTI = 2
PAIR_OVERFLOW = 3


def _side_code(f, ovf, max_tot, mm_delta):
    """Compact per-mate classification from finalize_fast stats — the
    same rule as the SE compact pass (eHRMMDelta uniqueness)."""
    aligned = f["low_mm"] <= max_tot
    unique = (aligned & ~ovf & (f["n_low"] == 1)
              & ((f["nxt_mm"] - f["low_mm"]) >= mm_delta))
    best = torch.where(f["hit_mm"] == f["low_mm"][:, None], f["hit_id"],
                       INT32_MAX).amin(1)
    return torch.where(unique, best,
                       torch.where(aligned, -2, -1)).to(torch.int32)


def _pair_rows(f1, f2, ovf1, ovf2, starts, *, L1, L2, max_tot, mm_delta,
               min_ins, max_ins):
    """AcceptProvPE cross-product over both mates' top-max_ml hits ->
    [B, 12] int32 rows (module docstring)."""
    code1 = _side_code(f1, ovf1, max_tot, mm_delta)
    code2 = _side_code(f2, ovf2, max_tot, mm_delta)
    h1, m1 = f1["hit_id"], f1["hit_mm"]            # [B, ML]
    h2, m2 = f2["hit_id"], f2["hit_mm"]
    p1 = h1 >> 1
    s1 = h1 & 1
    p2 = h2 >> 1
    s2 = h2 & 1
    ok1 = (h1 != INT32_MAX) & (m1 <= max_tot)
    ok2 = (h2 != INT32_MAX) & (m2 <= max_tot)
    # chromosome of each hit: an empty hit's p = INT32_MAX >> 1 lands past
    # the last start, and ok1/ok2 drop it anyway
    c1 = torch.searchsorted(starts, p1.contiguous(), right=True)
    c2 = torch.searchsorted(starts, p2.contiguous(), right=True)

    p1e, s1e, c1e = p1[:, :, None], s1[:, :, None], c1[:, :, None]
    p2e, s2e, c2e = p2[:, None, :], s2[:, None, :], c2[:, None, :]
    fwd1 = s1e == 0
    order_ok = torch.where(fwd1, p2e >= p1e, p1e >= p2e)
    left = torch.where(fwd1, p1e, p2e)
    right_end = torch.where(fwd1, p2e + L2, p1e + L1)
    insert = right_end - left                      # [B, ML, ML]
    ok = (ok1[:, :, None] & ok2[:, None, :] & (s1e != s2e)
          & (c1e == c2e) & order_ok
          & (insert >= min_ins) & (insert <= max_ins))
    score = torch.where(ok, m1[:, :, None] + m2[:, None, :], INT32_MAX)
    B, ML = p1.shape
    # flattened mate-1 hit major, as JAX: argmin's first minimum decides
    flat = score.reshape(B, ML * ML)
    best = flat.amin(1)
    besti = flat.argmin(1)                          # int64 [B]
    bi, bj = besti // ML, besti % ML

    def take(a, idx):
        return a.gather(1, idx[:, None])[:, 0]
    bid1 = take(h1, bi)
    bid2 = take(h2, bj)
    bmm1 = take(m1, bi)
    bmm2 = take(m2, bj)
    btlen = take(insert.reshape(B, ML * ML), besti)
    pflat = p1e.expand(B, ML, ML).reshape(B, ML * ML)
    qflat = p2e.expand(B, ML, ML).reshape(B, ML * ML)
    okf = ok.reshape(B, ML * ML)
    tie = (okf & (flat == best[:, None])
           & ((pflat != take(pflat, besti)[:, None])
              | (qflat != take(qflat, besti)[:, None]))).any(1)
    have = best != INT32_MAX
    overflow = ovf1 | ovf2
    pcode = torch.where(overflow, PAIR_OVERFLOW,
                        torch.where(~have, PAIR_NONE,
                                    torch.where(tie, PAIR_MULTI,
                                                PAIR_ACCEPT)))
    i32 = torch.int32
    return torch.stack([torch.where(have, bid1, -1).to(i32),
                        torch.where(have, bid2, -1).to(i32),
                        bmm1.to(i32), bmm2.to(i32),
                        torch.where(have, btlen, 0).to(i32),
                        pcode.to(i32), code1, code2,
                        f1["low_mm"].to(i32), f2["low_mm"].to(i32),
                        ovf1.to(i32), ovf2.to(i32)], dim=1)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 of the same 32 bits (the
    uint32 -> int32 reinterpretation JAX's int32 shifts wrap into)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_rows6(rows: torch.Tensor) -> torch.Tensor:
    """[B, 12] int32 pair rows -> [B, 6] int32 wire words: words 0/1 =
    ids, word 2 = mm1 | mm2<<8 | tlen<<16, word 3 = pcode | ovf1<<2 |
    ovf2<<3 | low1<<8 | low2<<16, words 4/5 = side codes. mm/low clamp to
    255 and tlen to 65535; a tlen >= 32768 sets word 2's sign bit, which
    `unpack_rows12` reads back through uint32. Computed in int64 and
    wrapped to int32 explicitly."""
    r = rows.to(torch.int64)
    mm1 = r[:, 2].clamp(0, 255)
    mm2 = r[:, 3].clamp(0, 255)
    tlen = r[:, 4].clamp(0, 65535)
    low1 = r[:, 8].clamp(0, 255)
    low2 = r[:, 9].clamp(0, 255)
    w2 = mm1 | (mm2 << 8) | (tlen << 16)
    w3 = (r[:, 5] | (r[:, 10] << 2) | (r[:, 11] << 3)
          | (low1 << 8) | (low2 << 16))
    return torch.stack([rows[:, 0], rows[:, 1], _wrap32(w2), _wrap32(w3),
                        rows[:, 6], rows[:, 7]], dim=1)


def unpack_rows12(a: np.ndarray) -> np.ndarray:
    """Host-side inverse of pack_rows6: [N, 6] wire words -> [N, 12].
    Passes [N, 12] arrays through (the passes skip packing when the insert
    ceiling exceeds the 16-bit tlen field)."""
    if a.shape[1] == 12:
        return a
    out = np.empty((len(a), 12), np.int32)
    out[:, 0] = a[:, 0]
    out[:, 1] = a[:, 1]
    w2 = a[:, 2].astype(np.uint32)
    out[:, 2] = w2 & 255
    out[:, 3] = (w2 >> 8) & 255
    out[:, 4] = (w2 >> 16) & 0xFFFF
    w3 = a[:, 3].astype(np.uint32)
    out[:, 5] = w3 & 3
    out[:, 10] = (w3 >> 2) & 1
    out[:, 11] = (w3 >> 3) & 1
    out[:, 8] = (w3 >> 8) & 255
    out[:, 9] = (w3 >> 16) & 255
    out[:, 6] = a[:, 4]
    out[:, 7] = a[:, 5]
    return out


def _mate_stats(gview, sa, lut2, planes, *, kw, n_compact, n_extend,
                max_ml, max_per_bucket=None):
    ids, mm, ovf = _cands_core_v4(gview, sa, lut2, planes,
                                  n_compact=n_compact, n_extend=n_extend,
                                  max_per_bucket=max_per_bucket, **kw)
    return finalize_fast(ids.T, mm.T, max_ml=max_ml), ovf


def pe_pass_packed(gview, sa, lut2, starts, r2b1, nl1, r2b2, nl2, *,
                   genome_len: int, offsets: tuple, lut_k: int,
                   read_len: int, n_compact: int, n_extend: int,
                   max_ml: int, max_tot: int, mm_delta: int,
                   min_ins: int, max_ins: int,
                   tier2: tuple | None = (512, 192, 96),
                   tier3: tuple | None = (64, 2048)):
    """Paired-end pass: 2-bit packed mates in ([B, ceil(L/4)] uint8 and
    their sparse N lists), [B, 6] wire words out (`pack_rows6`; [B, 12]
    rows when max_ins > 65535). `starts` is the genome's int32 chromosome
    starts on the device.

    tier2 = (E2, NC2, NS2): pairs whose tier-1 candidate compaction
    overflowed on either mate re-run both mates at the deeper capacities.
    tier3 = (E3, NC3): pairs still overflowing re-run CAPPED
    (max_per_bucket = NC3 // n_buckets, NS3 = NC3), which cannot overflow.
    Pairs beyond the E2/E3 slots keep PAIR_OVERFLOW for the host's
    escalation."""
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len)
    pair_kw = dict(L1=read_len, L2=read_len, max_tot=max_tot,
                   mm_delta=mm_delta, min_ins=min_ins, max_ins=max_ins)
    planes1 = words_from_2bit(r2b1, nl1, read_len)
    planes2 = words_from_2bit(r2b2, nl2, read_len)
    f1, ovf1 = _mate_stats(gview, sa, lut2, planes1, kw=kw,
                           n_compact=n_compact, n_extend=n_extend,
                           max_ml=max_ml)
    f2, ovf2 = _mate_stats(gview, sa, lut2, planes2, kw=kw,
                           n_compact=n_compact, n_extend=n_extend,
                           max_ml=max_ml)
    out = _pair_rows(f1, f2, ovf1, ovf2, starts, **pair_kw)
    B = out.shape[0]
    dev = out.device

    def escalate(out, tier_caps, capped):
        E, NC2 = tier_caps[0], tier_caps[1]
        NS2 = tier_caps[2] if len(tier_caps) > 2 else NC2
        cap = max(1, NC2 // (2 * len(offsets))) if capped else None
        esc = out[:, 5] == PAIR_OVERFLOW
        n_esc = esc.sum(dtype=torch.int32)
        ecum = torch.cumsum(esc.to(torch.int32), 0, dtype=torch.int32)
        e = torch.arange(E, dtype=torch.int32, device=dev)
        # row of the (e+1)-th escalated pair: the count of ecum <= e
        ridx = torch.searchsorted(ecum, e, right=True).clamp(0, B - 1)
        egood = e < n_esc.clamp(max=E)
        ep1 = tuple(p[:, ridx] for p in planes1)
        ep2 = tuple(p[:, ridx] for p in planes2)
        g1, o1 = _mate_stats(gview, sa, lut2, ep1, kw=kw, n_compact=NC2,
                             n_extend=NS2, max_ml=max_ml,
                             max_per_bucket=cap)
        g2, o2 = _mate_stats(gview, sa, lut2, ep2, kw=kw, n_compact=NC2,
                             n_extend=NS2, max_ml=max_ml,
                             max_per_bucket=cap)
        if capped:   # capped exploration is total by construction
            o1 = torch.zeros_like(o1)
            o2 = torch.zeros_like(o2)
        rows2 = _pair_rows(g1, g2, o1, o2, starts, **pair_kw)
        tgt = torch.where(egood, ridx, 2 ** 30)    # out of range: dropped
        return scatter_set_drop(out, tgt, rows2)

    if tier2 is not None:
        out = escalate(out, tier2, capped=False)
    if tier3 is not None:
        out = escalate(out, tier3, capped=True)
    return pack_rows6(out) if max_ins <= 65535 else out
