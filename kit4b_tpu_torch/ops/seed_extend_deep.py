"""Deep capped candidate exploration: the repeat-dense escalation tier of
paired-end kalign.

Port of kit4b_tpu/ops/seed_extend_deep.py. A mate whose seed buckets hold
thousands of entries cannot run the [NC, NC, B] dedup of the v4 core at the
capacities it needs. This pass explores a capped budget of C = n_blocks *
block_size candidate ranks per read in one flat [C, E] pass: rank ->
bucket by a search over the per-bucket running counts, one suffix-array and
one genome-row gather per rank, XOR + popcount mismatches, and
canonicalisation to the first exact window among the EXPLORED windows,
which emits every locus exactly once without a dedup.

Reference parity:
  * per-bucket cap = budget / explored buckets — the MaxIter truncation
    ladder (ngskit4b/KAligner.h:53-56);
  * buckets with cnt > skip_bucket are skipped entirely, as
    LocateCoreMultiples skips a core whose exact-match count reaches
    MaxIter (libkit4b/SfxArray.cpp:6592);
  * n_sel explores only the K least-populated buckets of a read (rarest-K
    seeds);
  * the pass is TOTAL: rows never come back PAIR_OVERFLOW.

Words ride the int64 carrier of `ops.bits`. Where JAX counts the buckets
at or below a rank through a one-hot [C, D, E] comparison the port runs
`searchsorted` over the same running counts: the same index.
`deep_cands_planes` takes the shard arguments of the position-sharded deep
pass (`parallel/mesh.py`), `key_lo` and `gview_base`, as the v4 core does.
"""
from __future__ import annotations

import torch

from .bits import popcount32, shl32, take_clamped
from .pe_packed import _pair_rows, pack_rows6
from .seed_extend_fast import INT32_MAX, MISM_BITS, _shape_constants, \
    _window_masks, finalize_fast
from .seed_extend_v4 import _cands_core_v4, _keys_be

# reference default MaxIter at standard sensitivity (KAligner.h:53-56):
# cores with more exact matches than this are skipped, not explored
DFLT_SKIP_BUCKET = 5000


def deep_stats_planes(gview, sa, lut2, planes, *, genome_len: int,
                      offsets: tuple, lut_k: int, read_len: int,
                      n_blocks: int, block_size: int, max_ml: int,
                      skip_bucket: int = DFLT_SKIP_BUCKET,
                      n_sel: int | None = None):
    """Capped deep exploration of one mate's candidates from packed word
    planes ([nw, E] lane-major): the finalize_fast stats dict (low_mm /
    n_low / nxt_mm [E], hit_id / hit_mm [E, max_ml]), complete under the
    cap, never overflowing."""
    ids, mm = deep_cands_planes(
        gview, sa, lut2, planes, genome_len=genome_len, offsets=offsets,
        lut_k=lut_k, read_len=read_len, n_blocks=n_blocks,
        block_size=block_size, skip_bucket=skip_bucket, n_sel=n_sel)
    return finalize_fast(ids.T, mm.T, max_ml=max_ml)


def deep_cands_planes(gview, sa, lut2, planes, *, genome_len: int,
                      offsets: tuple, lut_k: int, read_len: int,
                      n_blocks: int, block_size: int,
                      skip_bucket: int = DFLT_SKIP_BUCKET,
                      n_sel: int | None = None, key_lo=None,
                      gview_base=None):
    """Candidate core of the deep pass: (ids, mm) [C, E] int32 with
    INT32_MAX invalid, each locus once under explored-window
    canonicalisation. key_lo and gview_base (int or 0-d int32 tensor) are
    the key-range and position shard arguments of `_cands_core_v4`; a
    sharded caller gathers every shard's candidates and finalizes them
    together."""
    rw, rb, rcw, rcb = planes
    dev = rw.device
    nw, E = rw.shape
    L = read_len
    G = genome_len
    W = len(offsets)
    k = lut_k
    nw2 = nw + 1
    n_keys = lut2.shape[0]
    Gv = gview.shape[0]
    D = 2 * W
    C = n_blocks * block_size         # flat candidate budget
    K = n_sel if n_sel is not None else D
    cap = max(1, C // K)              # per explored bucket

    kf, okf = _keys_be(rw, rb, offsets, k)
    kr, okr = _keys_be(rcw, rcb, offsets, k)
    keys = torch.stack([kf, kr], dim=0)                     # [S, W, E]
    key_ok = torch.stack([okf, okr], dim=0)
    if key_lo is not None:
        keys = keys - key_lo
        key_ok = key_ok & (keys >= 0) & (keys < n_keys)
    pair = lut2[keys.clamp(0, n_keys - 1).long()]
    lo = pair[..., 0]
    cnt = torch.where(key_ok, pair[..., 1], 0)
    cnt = torch.where(cnt > skip_bucket, 0, cnt)   # reference MaxIter skip
    lo_d = lo.reshape(D, E)
    cnt_d = cnt.reshape(D, E)
    if K < D:
        # rarest-K: keep the K smallest non-empty buckets per read, the
        # first of equal counts in bucket order
        BIG = 2 ** 30
        cwork = torch.where(cnt_d > 0, cnt_d, BIG)
        explored = torch.zeros((D, E), dtype=torch.bool, device=dev)
        for _ in range(K):
            m = cwork.amin(0)
            pick = (cwork == m[None]) & (m[None] < BIG)
            first = (torch.cumsum(pick.to(torch.int32), 0,
                                  dtype=torch.int32) == 1) & pick
            explored = explored | first
            cwork = torch.where(first, BIG, cwork)
        cnt_d = torch.where(explored, cnt_d, 0)
    else:
        explored = cnt_d > 0
    cnt_d = cnt_d.clamp(max=cap)
    cum = torch.cumsum(cnt_d, 0, dtype=torch.int32)          # [D, E]
    cum0 = torch.cat([torch.zeros((1, E), dtype=torch.int32, device=dev),
                      cum[:-1]], dim=0)
    total = cum[-1]                                          # <= C

    # rank -> owning bucket: #{d: cum[d] <= rank}
    ranks = torch.arange(C, dtype=torch.int32, device=dev)
    b = torch.searchsorted(cum.T.contiguous(),
                           ranks[None, :].expand(E, C).contiguous(),
                           right=True).T.clamp(0, D - 1)     # [C, E]
    prev = cum0.gather(0, b)
    lo_b = lo_d.gather(0, b)
    sa_idx = lo_b + (ranks[:, None] - prev)
    slot_ok = ranks[:, None] < total[None, :]
    w_d = (b % W).to(torch.int32)
    strand = (b // W).to(torch.int32)
    consts = _shape_constants(tuple(offsets), k, L, dev)
    off_b = consts.off_w[w_d.long()]
    sa_pos = take_clamped(sa, sa_idx).to(torch.int32)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= G)

    posc = torch.where(valid, pos, 0)
    rel = posc if gview_base is None else posc - gview_base
    w0 = (rel >> 4).clamp(0, Gv - 1).long()
    rows = gview[w0].permute(0, 2, 1)                        # [C, 2nw2, E]
    gw = rows[:, :nw2]
    gb = rows[:, nw2:]
    sh = (2 * (posc & 15)).to(torch.int64)[:, None, :]
    hi_sh = 32 - sh

    def shift_align(words):
        lo_w = words[:, :nw] >> sh
        hi_w = torch.where(sh == 0, 0, shl32(words[:, 1:], hi_sh))
        return lo_w | hi_w

    ga = shift_align(gw)
    gba = shift_align(gb)
    st = strand[:, None, :]
    rp = torch.where(st == 0, rw[None], rcw[None])
    rbad = torch.where(st == 0, rb[None], rcb[None])
    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rbad) & MISM_BITS
    tmask = consts.tmask[None, :, None]
    bits = (mism | badb) & tmask
    mm = popcount32(bits).sum(1, dtype=torch.int32)          # [C, E]

    # first-exact-window canonicalisation over the EXPLORED windows of
    # the candidate's strand
    wmask = _window_masks(offsets, k, nw)
    exp_s = explored.reshape(2, W, E)
    fw = torch.full((C, E), W, dtype=torch.int32, device=dev)
    any_exact = torch.zeros((C, E), dtype=torch.bool, device=dev)
    for w in range(W - 1, -1, -1):
        ne = torch.zeros((C, E), dtype=torch.bool, device=dev)
        for wi in range(nw):
            if wmask[w, wi]:
                ne = ne | ((bits[:, wi] & int(wmask[w, wi])) != 0)
        expw = torch.where(strand == 0, exp_s[0, w][None, :],
                           exp_s[1, w][None, :])
        ex = ~ne & expw
        fw = torch.where(ex, w, fw)
        any_exact = any_exact | ex
    canonical = valid & any_exact & (fw == w_d)
    ids = torch.where(canonical, pos * 2 + strand, INT32_MAX)
    mm = torch.where(canonical, mm, INT32_MAX)
    return ids, mm


def deep_pe_pass_planes(gview, sa, lut2, starts, planes1, planes2, idxs,
                        *, genome_len: int, offsets: tuple, lut_k: int,
                        read_len: int, n_blocks: int, block_size: int,
                        max_ml: int, max_tot: int, mm_delta: int,
                        min_ins: int, max_ins: int,
                        skip_bucket: int = DFLT_SKIP_BUCKET,
                        deep1: bool = True, deep2: bool = True,
                        n_compact: int = 24, n_extend: int = 12,
                        n_sel: int | None = None):
    """Deep capped PE pass over the pair subset idxs [E] (gathered on the
    device from the group-resident word planes: planes1/planes2 are the
    (rw, rb, rcw, rcb) [nw, N] tuples of `words_from_2bit`): the deep
    exploration for the mate(s) deep1/deep2 select, the cheap tier-1 core
    (n_compact candidates) for the other, and the AcceptProvPE pairing ->
    [E, 6] `pack_rows6` wire words ([E, 12] rows when max_ins > 65535).
    TOTAL: rows never come back PAIR_OVERFLOW for a deep mate."""
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len, n_blocks=n_blocks, block_size=block_size,
              max_ml=max_ml, skip_bucket=skip_bucket, n_sel=n_sel)
    no_ovf = torch.zeros(idxs.shape[0], dtype=torch.bool,
                         device=idxs.device)

    def mate_stats(planes_full, deep):
        sel = idxs.clamp(0, planes_full[0].shape[1] - 1).long()
        planes = tuple(p[:, sel] for p in planes_full)
        if deep:
            return deep_stats_planes(gview, sa, lut2, planes, **kw), no_ovf
        ids, mm, ovf = _cands_core_v4(
            gview, sa, lut2, planes, genome_len=genome_len,
            offsets=offsets, lut_k=lut_k, read_len=read_len,
            n_compact=n_compact, n_extend=n_extend)
        return finalize_fast(ids.T, mm.T, max_ml=max_ml), ovf

    f1, o1 = mate_stats(planes1, deep1)
    f2, o2 = mate_stats(planes2, deep2)
    rows = _pair_rows(f1, f2, o1, o2, starts, L1=read_len, L2=read_len,
                      max_tot=max_tot, mm_delta=mm_delta, min_ins=min_ins,
                      max_ins=max_ins)
    return pack_rows6(rows) if max_ins <= 65535 else rows
