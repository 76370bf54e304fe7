"""kalign tier 1 (v4): packed-native seed-extend on 16-base words.

Port of kit4b_tpu/ops/seed_extend_v4.py: reads arrive 2-bit packed with a
sparse N list, become forward and reverse-complement word planes
[nw, B] (`words_from_2bit`), give big-endian seed keys per window
(`_keys_be`), and run seed lookup through the (lo, cnt) pair table, slot
compaction, locus dedup, extension by XOR + popcount and first-exact-window
canonicalisation (`_cands_core_v4`). `fast_pass_packed_v4` adds
classification and the in-graph tier 2 and returns the [B, 2] int32 rows.

Words ride the int64 carrier of `ops.bits`. The compaction keeps the JAX
slot order (strand, then window, then bucket rank) exactly; where JAX sums
a one-hot selection over the slot axis the port gathers the one selected
entry, which is the same value. Not ported: the `key_lo` and `gview_base`
arguments of the key- and position-sharded mesh passes (ROADMAP queue A
item 18).
"""
from __future__ import annotations

import torch

from .bits import bitrev2, not32, popcount32, scatter_add_drop_2d, \
    scatter_set_drop, shl32, take_clamped
from .seed_extend_fast import INT32_MAX, MISM_BITS, _shape_constants, \
    _window_masks
from .seed_extend_v3 import _classify_compact, pack_result2


def words_from_2bit(reads2b: torch.Tensor, nlist: torch.Tensor,
                    read_len: int):
    """[B, ceil(L/4)] uint8 packed reads + [K, 2] int32 sparse N list
    (read, base; out-of-range rows are padding) -> lane-major word planes
    (rw, rb, rcw, rcb), each [nw, B] int64-carried words: forward
    packed/bad words and the reverse complement's."""
    dev = reads2b.device
    B, L4 = reads2b.shape
    L = read_len
    nw = (L + 15) // 16
    ext = reads2b.new_zeros((B, 4 * nw))
    ext[:, :L4] = reads2b
    e = ext.reshape(B, nw, 4).to(torch.int64)
    w = e[..., 0] | (e[..., 1] << 8) | (e[..., 2] << 16) | (e[..., 3] << 24)
    tail = _shape_constants((), 0, L, dev).tail2
    w = w & tail[None, :]
    slot = (2 * (nlist[:, 1] & 15)).to(torch.int64)
    bit = torch.ones_like(slot) << slot
    bad = scatter_add_drop_2d(torch.zeros((B, nw), dtype=torch.int64,
                                          device=dev),
                              nlist[:, 0], nlist[:, 1] >> 4, bit)
    rw = w.T.contiguous()                                    # [nw, B]
    rb = bad.T.contiguous()

    # reverse complement: NOT complements every base; word-order reversal +
    # in-word 2-bit reversal reverses base order over the padded 16*nw
    # span; one funnel shift drops the 16*nw - L pad bases from the front
    frw = bitrev2(not32(w) & tail[None, :]).flip(1).T        # [nw, B]
    frb = bitrev2(bad).flip(1).T
    sh = 2 * (16 * nw - L)
    if sh:
        z = torch.zeros((1, B), dtype=torch.int64, device=dev)
        fw2 = torch.cat([frw, z], dim=0)
        fb2 = torch.cat([frb, z], dim=0)
        rcw = (fw2[:-1] >> sh) | shl32(fw2[1:], 32 - sh)
        rcb = (fb2[:-1] >> sh) | shl32(fb2[1:], 32 - sh)
    else:
        rcw, rcb = frw, frb
    # clear rc tail slots so rc words equal a zero-padded pack
    rcw = (rcw & tail[:, None]).contiguous()
    rcb = (rcb & tail[:, None]).contiguous()
    return rw, rb, rcw, rcb


def _extract24(words: torch.Tensor, off: int, k: int) -> torch.Tensor:
    """Static-offset 2k-bit window from lane-major word planes [nw, B]:
    the k bases starting at read position `off`, first base in the low
    bits (little-endian)."""
    bo = 2 * off
    j0 = bo // 32
    ws = bo % 32
    nw = words.shape[0]
    lo = words[j0] >> ws
    if ws + 2 * k > 32 and j0 + 1 < nw:
        lo = lo | shl32(words[j0 + 1], 32 - ws)
    return lo & ((1 << (2 * k)) - 1)


def _keys_be(words: torch.Tensor, bads: torch.Tensor, offsets: tuple,
             k: int):
    """Seed keys per offset: big-endian (lexicographic) LUT keys [W, B]
    int32 and window validity [W, B] bool."""
    keys, oks = [], []
    for off in offsets:
        le = _extract24(words, off, k)
        keys.append((bitrev2(le) >> (32 - 2 * k)).to(torch.int32))
        oks.append(_extract24(bads, off, k) == 0)
    return torch.stack(keys, dim=0), torch.stack(oks, dim=0)


def _seed_keys(planes, offsets, k, n_keys):
    """Keys of both strands [2, W, B] clamped to the table, and their
    validity (N-free window, key inside the table)."""
    rw, rb, rcw, rcb = planes
    kf, okf = _keys_be(rw, rb, offsets, k)
    kr, okr = _keys_be(rcw, rcb, offsets, k)
    keys = torch.stack([kf, kr], dim=0)                     # [S, W, B]
    key_ok = torch.stack([okf, okr], dim=0)
    key_ok = key_ok & (keys >= 0) & (keys < n_keys)
    return keys.clamp(0, n_keys - 1).long(), key_ok


def _compact(cnt_d: torch.Tensor, NC: int):
    """Slot -> (bucket, rank) compaction of per-bucket counts [D, B]:
    slot j of a read takes the bucket b whose cumulative count first
    exceeds j, at rank j - (count before b). Returns (total [B], b [NC, B]
    int64, rank [NC, B], slot_ok [NC, B])."""
    dev = cnt_d.device
    D, B = cnt_d.shape
    cum = torch.cumsum(cnt_d, 0, dtype=torch.int32)         # [D, B]
    total = cum[-1]
    j = torch.arange(NC, dtype=torch.int32, device=dev)
    b = (cum[None, :, :] <= j[:, None, None]).sum(1, dtype=torch.int32)
    b = b.clamp(0, D - 1).long()                            # [NC, B]
    cum0 = torch.cat([torch.zeros((1, B), dtype=torch.int32, device=dev),
                      cum[:-1]], dim=0)
    prev = cum0.gather(0, b)
    rank = j[:, None] - prev
    slot_ok = j[:, None] < total.clamp(max=NC)[None, :]
    return total, b, rank, slot_ok


def _slot_meta(b: torch.Tensor, off_w: torch.Tensor):
    """(window, strand, window offset) of each slot's bucket b = strand*W +
    window, each [NC, B] int32; off_w [W] int32 the window offsets."""
    W = off_w.shape[0]
    w_d = (b % W).to(torch.int32)
    strand = (b // W).to(torch.int32)
    return w_d, strand, off_w[w_d.long()]


def _dedup_extend(gview, planes, pos, strand, w_d, valid, overflow, *,
                  read_len, offsets, lut_k, n_extend):
    """Locus dedup (first slot per (pos, strand) survives), recompaction to
    NS extension slots, one genome-row gather per distinct locus, XOR +
    popcount mismatch count and first-exact-window canonicalisation.
    Returns (ids, mm) [NS, B] int32 and the updated overflow [B]."""
    rw, rb, rcw, rcb = planes
    dev = pos.device
    NC, B = pos.shape
    NS = n_extend
    nw = rw.shape[0]
    nw2 = nw + 1
    Gv = gview.shape[0]
    W = len(offsets)

    lid = torch.where(valid, pos * 2 + strand, INT32_MAX)    # [NC, B]
    eq = (lid[:, None, :] == lid[None, :, :]) & valid[None, :, :]
    tri = torch.ones((NC, NC), dtype=torch.bool, device=dev).tril(-1)
    dup = (eq & tri[:, :, None]).any(1)
    keep = valid & ~dup
    n_uniq = keep.sum(0, dtype=torch.int32)
    overflow = overflow | (n_uniq > NS)
    kcum = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    j2 = torch.arange(NS, dtype=torch.int32, device=dev)
    src = (kcum[None, :, :] <= j2[:, None, None]).sum(1, dtype=torch.int32)
    src = src.clamp(0, NC - 1).long()                       # [NS, B]
    pos2 = pos.gather(0, src)
    str2 = strand.gather(0, src)
    wd2 = w_d.gather(0, src)
    ok2 = j2[:, None] < n_uniq.clamp(max=NS)[None, :]

    # --- extension: one row-gather per distinct locus ----------------------
    posc = torch.where(ok2, pos2, 0)
    w0 = (posc >> 4).clamp(0, Gv - 1).long()
    rows = gview[w0].permute(0, 2, 1)                       # [NS, 2*nw2, B]
    gw = rows[:, :nw2]
    gb = rows[:, nw2:]
    sh = (2 * (posc & 15)).to(torch.int64)[:, None, :]
    hi_sh = 32 - sh

    def shift_align(words):
        lo_w = words[:, :nw] >> sh
        hi_w = torch.where(sh == 0, 0, shl32(words[:, 1:], hi_sh))
        return lo_w | hi_w

    ga = shift_align(gw)                                    # [NS, nw, B]
    gba = shift_align(gb)
    st = str2[:, None, :]
    rp = torch.where(st == 0, rw[None], rcw[None])
    rbad = torch.where(st == 0, rb[None], rcb[None])
    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rbad) & MISM_BITS
    tmask = _shape_constants(tuple(offsets), lut_k, read_len,
                             dev).tmask[None, :, None]
    bits = (mism | badb) & tmask
    mm = popcount32(bits).sum(1, dtype=torch.int32)         # [NS, B]

    # --- first-exact-window canonicalisation -------------------------------
    wmask = _window_masks(offsets, lut_k, nw)
    fw = torch.full((NS, B), W, dtype=torch.int32, device=dev)
    any_exact = torch.zeros((NS, B), dtype=torch.bool, device=dev)
    for w in range(W - 1, -1, -1):
        ne = torch.zeros((NS, B), dtype=torch.bool, device=dev)
        for wi in range(nw):
            if wmask[w, wi]:
                ne = ne | ((bits[:, wi] & int(wmask[w, wi])) != 0)
        ex = ~ne
        fw = torch.where(ex, w, fw)
        any_exact = any_exact | ex
    canonical = ok2 & any_exact & (fw == wd2)
    ids = torch.where(canonical, pos2 * 2 + str2, INT32_MAX)
    mm = torch.where(canonical, mm, INT32_MAX)
    return ids, mm, overflow


def _cands_core_v4(gview, sa, lut2, planes, *, genome_len, offsets, lut_k,
                   read_len, n_compact, n_extend=None, max_per_bucket=None):
    """Seed + compact + locus-dedup + extend from packed word planes.
    Returns (ids, mm) [NS, B] int32 (INT32_MAX invalid) and overflow [B]
    bool (raw candidates > NC or distinct loci > NS)."""
    nw, B = planes[0].shape
    L = read_len
    NC = n_compact
    W = len(offsets)
    D = 2 * W

    local, key_ok = _seed_keys(planes, offsets, lut_k, lut2.shape[0])
    pair = lut2[local]                                      # [S, W, B, 2]
    lo = pair[..., 0]
    cnt = torch.where(key_ok, pair[..., 1], 0)
    if max_per_bucket is not None:
        cnt = cnt.clamp(max=max_per_bucket)
    lo_d = lo.reshape(D, B)
    cnt_d = cnt.reshape(D, B)

    total, b, rank, slot_ok = _compact(cnt_d, NC)
    overflow = total > NC
    off_w = _shape_constants(tuple(offsets), lut_k, L, b.device).off_w
    w_d, strand, off_b = _slot_meta(b, off_w)
    sa_idx = lo_d.gather(0, b) + rank
    sa_pos = take_clamped(sa, sa_idx).to(torch.int32)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= genome_len)
    return _dedup_extend(gview, planes, pos, strand, w_d, valid, overflow,
                         read_len=L, offsets=offsets, lut_k=lut_k,
                         n_extend=n_extend or NC)


def _tier2(code, low, planes, gview, sa, lut2, tier2, *, max_tot_mm,
           mm_delta, **kw):
    """In-graph tier 2: the first E reads of class -3 rerun through
    `_cands_core_v4` at the deeper (NC2, NS2) caps and their (code, low)
    replace the tier-1 values. Reads past E keep -3."""
    E, NC2, NS2 = tier2
    dev = code.device
    B = code.shape[0]
    esc = code == -3
    n_esc = esc.sum(dtype=torch.int32)
    ecum = torch.cumsum(esc.to(torch.int32), 0, dtype=torch.int32)
    e = torch.arange(E, dtype=torch.int32, device=dev)
    # index of the (e+1)-th escalated read: the count of ecum <= e
    ridx = torch.searchsorted(ecum, e, right=True).clamp(0, B - 1)
    egood = e < n_esc.clamp(max=E)
    eplanes = tuple(p[:, ridx] for p in planes)             # [nw, E]
    ids2, mm2, ovf2 = _cands_core_v4(gview, sa, lut2, eplanes,
                                     n_compact=NC2, n_extend=NS2, **kw)
    code2, low2, _ = _classify_compact(ids2, mm2, ovf2,
                                       max_tot_mm=max_tot_mm,
                                       mm_delta=mm_delta)
    tgt = torch.where(egood, ridx, 2 ** 30)                 # OOB -> dropped
    return scatter_set_drop(code, tgt, code2), scatter_set_drop(low, tgt,
                                                                low2)


def fast_pass_packed_v4(gview, sa, lut2, reads2b, nlist, *, genome_len,
                        offsets, lut_k, n_compact, max_tot_mm, mm_delta,
                        read_len, n_extend=None, max_per_bucket=None,
                        tier2=(128, 192, 96)):
    """2-bit reads in, [B, 2] int32 rows out (pack_result2), including the
    tier-2 escalation on the device."""
    planes = words_from_2bit(reads2b, nlist, read_len)
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len, max_per_bucket=max_per_bucket)
    ids, mm, overflow = _cands_core_v4(gview, sa, lut2, planes,
                                       n_compact=n_compact,
                                       n_extend=n_extend, **kw)
    code, low, _ = _classify_compact(ids, mm, overflow,
                                     max_tot_mm=max_tot_mm,
                                     mm_delta=mm_delta)
    if tier2 is not None:
        code, low = _tier2(code, low, planes, gview, sa, lut2, tier2,
                           max_tot_mm=max_tot_mm, mm_delta=mm_delta, **kw)
    return pack_result2(code, low)
