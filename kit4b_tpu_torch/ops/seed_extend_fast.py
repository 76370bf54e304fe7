"""Batched seed-and-extend pass with full hit stats: the host escalation
tiers of kalign.

Port of kit4b_tpu/ops/seed_extend_fast.py (`fast_candidates`,
`finalize_fast`, `fast_pass`), the
paired-end orphan rescue scan (`window_scan_pe`, `_phase_scan`), plus its
host helpers (`fast_offsets`, `make_gview`, `_tail_mask`,
`_window_masks`), which are re-homed here because the JAX module imports
jax at module top.
`fast_candidates` takes both strands of plain DNA reads by default, or one
strand of reads the caller has collapsed to a 3-letter alphabet, keyed in
radix `lut_base` through `digit_map` (the bisulfite pass,
align/bisulfite.py).
32-bit words ride the int64 carrier of `ops.bits`; counts, positions and
ids are int32 as in JAX. Bit-identical to the JAX pass on the same inputs
(tests/test_torch_kalign_passes.py).

The constant tensors of a shape (seed offsets, digit weights, tail and
window masks) are built on the device once (`_shape_constants`, which the
v4/v5 cores, the deep pass and `words_from_2bit` share), so a pass copies
nothing from host memory: such a copy would wait for the stream,
and callers keep several batches in flight.

Not ported: `fast_pass_compact` (an index with 2^31
clean suffixes or more) and the host-probe window scans `window_scan` and
`window_scan_packed`, which JAX's paired-end rescue reaches only on the
byte-tensor `pe_pass` route, taken past the int32 locus-id ceiling
(item 18a, whose refusal stands).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .bits import popcount32, shl32, take_clamped, to_words

INT32_MAX = int(np.iinfo(np.int32).max)
MISM_BITS = 0x55555555


def fast_offsets(read_len: int, lut_k: int, max_mm: int) -> tuple:
    """Evenly spread disjoint seed-window offsets.

    W = min(max_mm + 1, L // k) windows guarantee discovery of all loci with
    <= W - 1 mismatches; spreading them across the read (stride >= k) keeps
    the pigeonhole property while covering 3' error-dense tails."""
    L, k = read_len, lut_k
    W = min(max_mm + 1, L // k)
    if W <= 0:
        return ()
    if W == 1:
        return (0,)
    stride = (L - k) // (W - 1)
    return tuple(i * stride for i in range(W))


def make_gview(gpack: np.ndarray, gbad: np.ndarray, nw2: int) -> np.ndarray:
    """[Gv, 2*nw2] uint32 row-gather view on the host: row i =
    gpack[i:i+nw2] ++ gbad[i:i+nw2]. The position-sharded index
    (`parallel.mesh.shard_index_by_position`) builds its blocks with it."""
    p = np.lib.stride_tricks.sliding_window_view(gpack, nw2)
    b = np.lib.stride_tricks.sliding_window_view(gbad, nw2)
    return np.concatenate([p, b], axis=1).astype(np.uint32)


def make_gview_device(gpack: np.ndarray, gbad: np.ndarray, nw2: int,
                      device: torch.device) -> torch.Tensor:
    """[Gv, 2*nw2] row-gather view of the packed genome, built on the
    device in int64-carried words: row i = gpack[i:i+nw2] ++
    gbad[i:i+nw2]. One row fetch supplies the full extension context for a
    candidate whose read-start word is i."""
    gp = to_words(gpack).to(device)
    gb = to_words(gbad).to(device)
    return torch.cat([gp.unfold(0, nw2, 1), gb.unfold(0, nw2, 1)], dim=1)


def pack_reads0(seqs: torch.Tensor, nw: int):
    """[B, S, L] uint8 codes -> phase-0 packed (rpack, rbad) [B, S, nw]
    int64-carried words."""
    B, S, L = seqs.shape
    ext = seqs.new_zeros((B, S, 16 * nw))
    ext[:, :, :L] = seqs
    r = ext.reshape(B, S, nw, 16).to(torch.int64)
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=seqs.device)
    rpack = ((r & 3) << shifts).sum(-1)
    rbad = ((r >= 4).to(torch.int64) << shifts).sum(-1)
    return rpack, rbad


def _tail_mask(read_len: int, nw: int) -> np.ndarray:
    """uint32 [nw]: flag bit 2m of word j set iff base 16j + m < read_len."""
    out = np.zeros(nw, dtype=np.uint32)
    for j in range(nw):
        for m in range(16):
            if 16 * j + m < read_len:
                out[j] |= np.uint32(1) << np.uint32(2 * m)
    return out


def _window_masks(offsets: tuple, lut_k: int, nw: int) -> np.ndarray:
    """uint32 [W, nw]: flag bits covering read bases [off, off+k)."""
    out = np.zeros((len(offsets), nw), dtype=np.uint32)
    for w, off in enumerate(offsets):
        for i in range(off, off + lut_k):
            out[w, i // 16] |= np.uint32(1) << np.uint32(2 * (i % 16))
    return out


class ShapeConstants(NamedTuple):
    """The constant tensors of one pass shape, on the pass's device."""
    offs: torch.Tensor     # [W, k] int64 seed base offsets
    powb: torch.Tensor     # [k] int32 digit weights
    off_w: torch.Tensor    # [W] int32 window offsets
    tmask: torch.Tensor    # [nw] tail mask, flag bit of each base
    wmask: torch.Tensor    # [W, nw] window masks
    tail2: torch.Tensor    # [nw] tail mask, both bits of each base


@functools.lru_cache(maxsize=64)
def _shape_constants(offsets: tuple, lut_k: int, read_len: int,
                     device: torch.device,
                     lut_base: int = 4) -> ShapeConstants:
    """The ShapeConstants of (offsets, lut_k, read_len) on `device`, built
    once; offsets () and lut_k 0 give a read length's tail masks alone.
    The digit weights are powers of `lut_base`."""
    nw = (read_len + 15) // 16
    offs = (torch.tensor(offsets, dtype=torch.int64)[:, None]
            + torch.arange(lut_k)[None, :])
    powb = torch.tensor([lut_base ** e for e in range(lut_k - 1, -1, -1)],
                        dtype=torch.int32)
    off_w = torch.tensor(offsets, dtype=torch.int32)
    tm = _tail_mask(read_len, nw)
    wmask = _window_masks(offsets, lut_k, nw)
    return ShapeConstants(*(t.to(device) for t in (
        offs, powb, off_w, to_words(tm), to_words(wmask),
        to_words(tm | (tm << 1)))))


@functools.lru_cache(maxsize=8)
def _digit_map(digit_map: tuple, device: torch.device) -> torch.Tensor:
    """A code-to-digit map as an int32 tensor on `device`, built once."""
    return torch.tensor(digit_map, dtype=torch.int32, device=device)


def revcomp_device(reads: torch.Tensor) -> torch.Tensor:
    comp = torch.where(reads < 4, 3 - reads, reads)
    return comp.flip(-1)


def fast_candidates(gview: torch.Tensor,   # [Gv, 2*nw2] genome context rows
                    sa: torch.Tensor,      # [M] int32 clean-suffix positions
                    lut: torch.Tensor,     # [n_keys + 1] int32 bucket starts
                    reads: torch.Tensor,   # [B, L] uint8 codes
                    *,
                    genome_len: int,
                    offsets: tuple,
                    lut_k: int,
                    n_compact: int,
                    single_strand: int | None = None,
                    lut_base: int = 4,
                    digit_map: tuple | None = None,
                    max_per_bucket: int | None = None):
    """Seed + compact + extend + canonicalise. Returns (ids, mm, overflow):
    ids/mm [B, NC] int32 (INT32_MAX invalid), each surviving entry a
    deduplicated locus; overflow [B] bool -> escalate the read.

    single_strand: None evaluates both strands (reads + their revcomp);
    0/1 evaluates `reads` as given, labelling hits with that strand bit
    (the bisulfite path pre-collapses/pre-revcomps its read tensors). A
    seed's key is its digits (`digit_map` of each base code, the code
    itself by default) in radix `lut_base`."""
    dev = reads.device
    B, L = reads.shape
    G = genome_len
    NC = n_compact
    W = len(offsets)
    k = lut_k
    nw = (L + 15) // 16
    nw2 = nw + 1
    n_keys = lut.shape[0] - 1
    Gv = gview.shape[0]
    if single_strand is None:
        seqs = torch.stack([reads, revcomp_device(reads)], dim=1)  # [B,2,L]
    else:
        seqs = reads[:, None, :]                                   # [B,1,L]
    S = seqs.shape[1]
    D = S * W
    offs, powb, off_w, tmask, wmask, _ = _shape_constants(
        tuple(offsets), k, L, dev, lut_base)

    # --- seed lookup: bucket (lo, cnt) per (strand, window) ----------------
    bases = seqs[:, :, offs]                                     # [B,S,W,k]
    digits = torch.where(bases < 4, bases, 0).to(torch.int32)
    if digit_map is not None:
        digits = _digit_map(tuple(digit_map), dev)[digits.long()]
    keys = (digits * powb).sum(-1, dtype=torch.int32)            # [B,S,W]
    key_ok = (bases < 4).all(-1)
    in_shard = (keys >= 0) & (keys < n_keys)
    local = keys.clamp(0, n_keys - 1).long()
    lo = lut[local].to(torch.int32)
    cnt = lut[local + 1].to(torch.int32) - lo
    cnt = torch.where(key_ok & in_shard, cnt, 0)
    if max_per_bucket is not None:
        # reference MaxIter analog (KAligner.h:53-56): truncated buckets
        # explore their first max_per_bucket entries
        cnt = cnt.clamp(max=max_per_bucket)
    lo_d = lo.reshape(B, D)
    cnt_d = cnt.reshape(B, D)          # flat bucket order d = strand*W + w

    # --- slot -> (bucket, rank) compaction (no sort) -----------------------
    cum = torch.cumsum(cnt_d, 1, dtype=torch.int32)              # [B, D]
    total = cum[:, -1]
    overflow = total > NC
    j = torch.arange(NC, dtype=torch.int32, device=dev)
    b = (cum[:, None, :] <= j[None, :, None]).sum(2, dtype=torch.int32)
    b = b.clamp(0, D - 1).long()                                 # [B, NC]
    cum0 = torch.nn.functional.pad(cum, (1, 0))
    prev = cum0.gather(1, b)
    rank = j[None, :] - prev
    sa_idx = lo_d.gather(1, b) + rank
    slot_ok = j[None, :] < total.clamp(max=NC)[:, None]

    w_d = (b % W).to(torch.int32)
    if single_strand is None:
        strand = (b // W).to(torch.int32)
    else:
        strand = torch.full_like(w_d, single_strand)
    off_b = off_w[w_d.long()]
    sa_pos = take_clamped(sa, sa_idx).to(torch.int32)
    pos = sa_pos - off_b
    valid = slot_ok & (pos >= 0) & (pos + L <= G)

    # --- extension: one context-row gather per candidate -------------------
    rpack, rbad = pack_reads0(seqs, nw)                          # [B,2,nw]
    posv = torch.where(valid, pos, 0)
    w0 = (posv >> 4).clamp(0, Gv - 1).long()
    rows = gview[w0]                                             # [B,NC,2nw2]
    gw = rows[..., :nw2]
    gb = rows[..., nw2:]
    sh = (2 * (posv & 15)).to(torch.int64)[..., None]
    hi_sh = 32 - sh

    def shift_align(words):
        lo_w = words[..., :nw] >> sh
        hi_w = torch.where(sh == 0, 0, shl32(words[..., 1:], hi_sh))
        return lo_w | hi_w

    ga = shift_align(gw)
    gba = shift_align(gb)
    if S == 1:
        rp = rpack[:, None, 0, :]
        rb = rbad[:, None, 0, :]
    else:
        st = strand[..., None]
        rp = torch.where(st == 0, rpack[:, None, 0, :], rpack[:, None, 1, :])
        rb = torch.where(st == 0, rbad[:, None, 0, :], rbad[:, None, 1, :])

    x = ga ^ rp
    mism = (x | (x >> 1)) & MISM_BITS
    badb = (gba | rb) & MISM_BITS
    bits = (mism | badb) & tmask                                 # [B,NC,nw]
    mm = popcount32(bits).sum(-1, dtype=torch.int32)

    # --- first-exact-window canonicalisation -------------------------------
    notexact = ((bits[:, :, None, :] & wmask[None, None]) != 0).any(-1)
    exact = ~notexact                                            # [B,NC,W]
    any_exact = exact.any(-1)
    # jnp.argmax of a bool row: index of the first True, 0 when none
    widx = torch.arange(W, dtype=torch.int32, device=dev)
    fw = torch.where(exact, widx, W).amin(-1)
    fw = torch.where(any_exact, fw, 0)
    canonical = valid & any_exact & (fw == w_d)

    ids = torch.where(canonical, pos * 2 + strand, INT32_MAX)
    mm = torch.where(canonical, mm, INT32_MAX)
    return ids, mm, overflow


def finalize_fast(ids: torch.Tensor, mm: torch.Tensor, *, max_ml: int):
    """Masked best/next-best stats + top-max_ml hits ordered by (mm, id).

    ids/mm [B, N] int32 with INT32_MAX invalid. The two-key sort of JAX
    (`lax.sort((mm, ids), num_keys=2)`) is one sort of the int64 key
    mm << 32 | id; both are non-negative."""
    B, N = ids.shape
    ok = ids != INT32_MAX
    low = mm.amin(1)
    n_low = ((mm == low[:, None]) & ok).sum(1, dtype=torch.int32)
    nxt = torch.where(mm > low[:, None], mm, INT32_MAX).amin(1)

    key = torch.sort((mm.to(torch.int64) << 32) | ids.to(torch.int64),
                     dim=1).values
    mm_s = (key >> 32).to(torch.int32)
    id_s = (key & 0xFFFFFFFF).to(torch.int32)
    hit_mm = mm_s[:, :max_ml]
    hit_id = torch.where(hit_mm == INT32_MAX, INT32_MAX, id_s[:, :max_ml])
    if max_ml > N:
        pad = (0, max_ml - N)
        hit_mm = torch.nn.functional.pad(hit_mm, pad, value=INT32_MAX)
        hit_id = torch.nn.functional.pad(hit_id, pad, value=INT32_MAX)
    return {"low_mm": low, "n_low": n_low, "nxt_mm": nxt,
            "hit_id": hit_id, "hit_mm": hit_mm}


def fast_pass(gview: torch.Tensor, sa: torch.Tensor, lut: torch.Tensor,
              reads: torch.Tensor, *, genome_len: int, offsets: tuple,
              lut_k: int, n_compact: int, max_ml: int,
              max_per_bucket: int | None = None):
    """Single-device fast pass over a read batch, both strands: dict with
    low_mm/n_low/nxt_mm [B], hit_id/hit_mm [B, max_ml], overflow [B].
    overflow=True means the read's candidate total exceeded n_compact and
    its stats are incomplete; the caller escalates it to a bigger tier."""
    ids, mm, overflow = fast_candidates(
        gview, sa, lut, reads, genome_len=genome_len, offsets=offsets,
        lut_k=lut_k, n_compact=n_compact, max_per_bucket=max_per_bucket)
    out = finalize_fast(ids, mm, max_ml=max_ml)
    out["overflow"] = overflow
    return out


def window_scan_pe(gview: torch.Tensor, planes1, planes2,
                   idxs: torch.Tensor, which: torch.Tensor,
                   want_strand: torch.Tensor, starts: torch.Tensor,
                   *, genome_len: int, scan_len: int, read_len: int):
    """PE orphan rescue scan (the reference's AlignPartnerRead,
    KAligner.cpp:3333) with the probe gathered on the device: the orphan
    mate's words come from the group-resident word planes (the
    (rw, rb, rcw, rcb) [nw, N] tuples of `words_from_2bit`), so only
    idxs/which/want_strand/starts [R] int32 cross from the host. which[r]
    = 1 rescues mate 1, 2 mate 2; want_strand 0 scans the forward words, 1
    the reverse complement's. Returns (best_mm, best_pos, n_best) [R]
    int32 over the genome positions [start, start + scan_len)."""
    sel_i = idxs.clamp(0, planes1[0].shape[1] - 1).long()
    two = (which == 2)[None, :]

    def sel(k):
        return torch.where(two, planes2[k][:, sel_i], planes1[k][:, sel_i])
    fwd = (want_strand == 0)[None, :]
    pw = torch.where(fwd, sel(0), sel(2)).T        # [R, nw]
    pb = torch.where(fwd, sel(1), sel(3)).T
    return _phase_scan(gview, pw, pb, starts, genome_len=genome_len,
                       scan_len=scan_len, read_len=read_len)


def _phase_scan(gview, pw, pb, starts, *, genome_len: int, scan_len: int,
                read_len: int):
    """The phase-sliced scan body: probe words pw/pb [R, nw]. One
    contiguous run of genome words per probe (the first word of each
    gview row), pre-aligned to `starts` by a per-probe funnel shift; then
    16 static phase-shifted word streams turn every scan position
    p = 16t + s into a slice: words [t, t + nw) of phase s."""
    dev = pw.device
    R = pw.shape[0]
    L = read_len
    P = scan_len
    nw = (L + 15) // 16
    nw2g = gview.shape[1] // 2
    Gv = gview.shape[0]
    T = (P + 15) // 16
    nwblk = T + nw + 1

    base_w = starts >> 4
    idx = (base_w[:, None] + torch.arange(nwblk + 1, dtype=torch.int32,
                                          device=dev)[None, :]
           ).clamp(0, Gv - 1).long()
    gw = gview[idx, 0]                                   # [R, nwblk+1]
    gb = gview[idx, nw2g]
    # pre-align the streams to `starts` (sub-word funnel, per probe)
    sh0 = (2 * (starts & 15)).to(torch.int64)[:, None]
    aw = torch.where(sh0 == 0, gw[:, :-1],
                     (gw[:, :-1] >> sh0) | shl32(gw[:, 1:], 32 - sh0))
    ab = torch.where(sh0 == 0, gb[:, :-1],
                     (gb[:, :-1] >> sh0) | shl32(gb[:, 1:], 32 - sh0))
    tmask = _tail_mask(L, nw)
    # phase s: bases starting at start + 16t + s live in words [t, t+nw)
    mm_st = []
    for s in range(16):
        if s == 0:
            ws, bs = aw, ab
        else:
            ws = (aw[:, :-1] >> 2 * s) | shl32(aw[:, 1:], 32 - 2 * s)
            bs = (ab[:, :-1] >> 2 * s) | shl32(ab[:, 1:], 32 - 2 * s)
        acc = torch.zeros((R, T), dtype=torch.int32, device=dev)
        for j in range(nw):
            x = ws[:, j:j + T] ^ pw[:, j:j + 1]
            mism = (x | (x >> 1)) & MISM_BITS
            badb = (bs[:, j:j + T] | pb[:, j:j + 1]) & MISM_BITS
            acc = acc + popcount32((mism | badb) & int(tmask[j]))
        mm_st.append(acc)
    mm = torch.stack(mm_st, dim=2).reshape(R, T * 16)    # p = 16t + s
    p = torch.arange(T * 16, dtype=torch.int32, device=dev)[None, :]
    pos = starts[:, None] + p
    valid = (p < P) & (pos >= 0) & (pos + L <= genome_len)
    mm = torch.where(valid, mm, INT32_MAX)
    best = mm.amin(1)
    n_best = (mm == best[:, None]).sum(1, dtype=torch.int32)
    prel = torch.where(mm == best[:, None], p, 2 ** 30).amin(1)
    best_pos = (starts + prel).clamp(0, genome_len - L)
    return best, best_pos, n_best
