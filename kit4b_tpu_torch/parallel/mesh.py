"""The dp x tp device mesh and the sharded kalign passes.

Port of kit4b_tpu/parallel/mesh.py. Axes:
  "dp" - data parallelism over read batches: each dp shard aligns its own
         rows of the batch;
  "tp" - index shard parallelism: the k-mer table (and its suffix-array
         entries) is cut by key range, or the genome by position, and each
         tp shard resolves only the seeds, or the loci, it owns.

A shard's candidates are disjoint from every other shard's (a locus is
emitted only by the shard that owns its first exact window's key, or its
position), so the tp shards' candidates, concatenated in shard order and
finalized, give the single-device result exactly.

JAX runs each pass as one `shard_map` program; the port runs the same
local function on each mesh cell in a loop, on the cell's device, and
stands in for the collectives:
  - `all_gather(..., "tp", axis=0, tiled=True)` -> `all_gather`: the tp
    shards' blocks concatenated in shard order on the dp shard's first
    device;
  - `psum` of the overflow flags over "tp" -> `psum`;
  - the output gather over "dp" -> the dp shards' rows concatenated on the
    mesh's first device.
`device_put` places an array as `jax.device_put(x, NamedSharding(mesh,
P(*spec)))` does: each cell holds its block of dimension 0.

Not ported, as dead code: `make_sharded_align_pass` and
`device_put_sharded_index`, which run `ops/seed_extend.align_pass`.
Every factory refuses genomes with 2*G+1 >= 2^31 (the single-device
refusal of align/kalign.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..ops.bits import to_words

_CEILING = ("genomes with 2*G+1 >= 2^31: the int32 locus id pos*2+strand "
            "wraps past 2^30 bases on the sharded passes too (ROADMAP.md "
            "queue C, 'int32 locus ids wrap past 2^30 bases'), so they need "
            "the per-shard offsets of ROADMAP.md queue A item 18")


class Mesh:
    """A grid of torch devices with named axes (the port's
    `jax.sharding.Mesh`): `devices` is an object array of `torch.device`
    whose dimensions are `axis_names`. A device may appear in several
    cells."""

    def __init__(self, devices, axis_names: tuple):
        grid = isinstance(devices, np.ndarray)
        shape = devices.shape if grid else (len(devices),)
        arr = np.empty(len(devices.flat) if grid else len(devices),
                       dtype=object)
        for i, d in enumerate(devices.flat if grid else devices):
            arr[i] = torch.device(d)
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def default_devices() -> list:
    """Every visible CUDA device; raises `DeviceUnavailable` without CUDA
    (the port never falls back to the CPU on its own)."""
    resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: int, tp: int = 1, devices=None) -> Mesh:
    """[dp, tp] mesh over the first dp*tp of `devices` (default: every
    visible CUDA device). `[torch.device("cpu")] * n` or
    `[torch.device("cuda", 0)] * n` give a mesh of n cells on one
    device."""
    devices = list(devices) if devices is not None else default_devices()
    if dp * tp > len(devices):
        raise ValueError(f"need {dp * tp} devices, have {len(devices)}")
    arr = np.empty(dp * tp, dtype=object)
    for i, d in enumerate(devices[:dp * tp]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(dp, tp), ("dp", "tp"))


# --- the collectives ----------------------------------------------------

def all_gather(parts: list, device: torch.device):
    """`jax.lax.all_gather(x, axis, axis=0, tiled=True)`: the shards'
    blocks concatenated in shard order, on `device`."""
    return torch.cat([p.to(device) for p in parts])


def psum(parts: list, device: torch.device):
    """`jax.lax.psum(x.astype(int32), axis)`: the elementwise int32 sum of
    the shards' values, on `device`."""
    total = None
    for p in parts:
        p = p.to(device=device, dtype=torch.int32)
        total = p if total is None else total + p
    return total


# --- placement ------------------------------------------------------------

def _tensor(x):
    """numpy or tensor -> tensor; uint32 words ride the int64 carrier of
    `ops.bits`, as every table of the port does."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return to_words(x)
    return torch.from_numpy(np.ascontiguousarray(x))


class Sharded:
    """An array placed on a [dp, tp] mesh: `local(d, t)` is the block that
    cell (d, t) holds, on that cell's device."""

    def __init__(self, blocks: list):
        self.blocks = blocks

    def local(self, d: int, t: int):
        return self.blocks[d][t]


def device_put(mesh: Mesh, x, spec: tuple = ()) -> Sharded:
    """Places x as `jax.device_put(x, NamedSharding(mesh, P(*spec)))`:
    spec () replicates it, ("dp",) or ("tp",) splits dimension 0 into that
    axis' size of equal blocks, one a shard. A cell gets its block on its
    device; cells on one device share one copy."""
    if isinstance(x, Sharded):
        return x
    x = _tensor(x)
    axis = spec[0] if spec else None
    n = mesh.shape[axis] if axis is not None else 1
    if x.shape[0] % n:
        raise ValueError(f"dimension 0 of size {x.shape[0]} does not split "
                         f"into {n} equal blocks over mesh axis {axis!r}")
    parts = torch.split(x, x.shape[0] // n) if n > 1 else (x,)
    dp, tp = mesh.devices.shape
    blocks = []
    for d in range(dp):
        row = []
        for t in range(tp):
            b = parts[{"dp": d, "tp": t}.get(axis, 0)]
            row.append(b.to(mesh.devices[d, t]))
        blocks.append(row)
    return Sharded(blocks)


def _gather_dp(mesh: Mesh, outs: list):
    """The output gather over "dp": each dp shard's rows (a tensor or a
    dict of tensors) concatenated on the mesh's first device."""
    dev = mesh.devices.flat[0]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k].to(dev) for o in outs]) for k in outs[0]}
    return torch.cat([o.to(dev) for o in outs])


def _check_ceiling(genome_len: int) -> None:
    if 2 * genome_len + 1 >= 2 ** 31:
        raise NotImplementedError(_CEILING)


# --- the index shards (host numpy) -----------------------------------------

def shard_index_by_key(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """Range-partition the k-mer LUT (and its SA entries) into `tp` shards.

    Returns (sa_shards [tp, Mpad], lut_shards [tp, keys_per+1], key_lo [tp]).
    Shard t owns keys [t*keys_per, (t+1)*keys_per); its local LUT is
    rebased so lut_local[0] == 0. SA shards are padded to equal length
    with zeros, which no bucket reaches."""
    n_keys = len(lut) - 1
    if n_keys % tp:
        raise ValueError(f"key space {n_keys} not divisible by tp={tp}")
    keys_per = n_keys // tp
    sa_parts, lut_parts, key_lo = [], [], []
    for t in range(tp):
        klo, khi = t * keys_per, (t + 1) * keys_per
        slo, shi = int(lut[klo]), int(lut[khi])
        sa_parts.append(sa_clean[slo:shi])
        lut_parts.append((lut[klo:khi + 1] - slo).astype(lut.dtype))
        key_lo.append(klo)
    mpad = max(len(p) for p in sa_parts)
    sa_shards = np.zeros((tp, mpad), dtype=sa_clean.dtype)
    for t, p_ in enumerate(sa_parts):
        sa_shards[t, : len(p_)] = p_
    return sa_shards, np.stack(lut_parts), np.asarray(key_lo, np.int32)


def shard_index_by_key_v3(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """shard_index_by_key for the pair-table passes: the per-shard LUT
    becomes (lo, cnt) pair rows [tp, keys_per, 2] int32."""
    sa_shards, lut_shards, key_lo = shard_index_by_key(sa_clean, lut, tp)
    lo = lut_shards[:, :-1].astype(np.int64)
    cnt = lut_shards[:, 1:].astype(np.int64) - lo
    lut2_shards = np.stack([lo, cnt], axis=2).astype(np.int32)
    return sa_shards, lut2_shards, key_lo


def shard_index_by_key_v5(sa_clean: np.ndarray, lut: np.ndarray, tp: int):
    """shard_index_by_key for the v5 flattened table: per-shard lut4 rows
    [tp, keys_per, 8] = [sa[lo..lo+6] (global positions), cnt]. A shard
    owning no suffix (tiny genomes, skewed key ranges at large tp) has
    only zero counts, so its position columns are zeros."""
    from ..ops.seed_extend_v5 import P_POS
    sa_shards, lut_shards, key_lo = shard_index_by_key(sa_clean, lut, tp)
    l4 = []
    for t in range(tp):
        lo = lut_shards[t, :-1].astype(np.int64)
        cnt = (lut_shards[t, 1:].astype(np.int64) - lo)
        sa_s = sa_shards[t].astype(np.int64)
        m = len(sa_s)
        cols = [sa_s[np.clip(lo + p, 0, max(m - 1, 0))] if m
                else np.zeros_like(lo) for p in range(P_POS)]
        l4.append(np.stack(cols + [cnt], axis=1).astype(np.int32))
    return sa_shards, np.stack(l4), key_lo


def shard_index_by_position(index, tp: int, read_len: int):
    """POSITION-range sharding: shard t owns the genome block
    [t*G/tp, (t+1)*G/tp) instead of a key range, so a device holds
    O(G/tp + L) of the genome:

      * its gview block covers the block plus a read-length halo on both
        sides (window offsets reach below the block, extension past it),
        from a 16-aligned base;
      * its suffix entries are the clean suffixes that point into the
        block (global positions, key order kept), with a full-key-space
        (lo, cnt) pair table over them;
      * every shard evaluates the whole read batch against its block; each
        locus belongs to one shard, so the merge is a concatenation.

    Returns (gview_blocks [tp, Gvb, 2*nw2] uint32 (pad rows mark every
    base invalid), base [tp] int32 global row-0 positions, sa_shards
    [tp, Mpad] int32 global positions, lut2_shards [tp, n_keys, 2] int32)."""
    from ..ops.extend_packed import pack_genome
    from ..ops.seed_extend_fast import make_gview
    g = index.genome
    G = len(g.seq)
    L = read_len
    nw2 = (L + 15) // 16 + 1
    k = index.lut_k
    n_keys = len(index.lut) - 1
    sa = index.sa_clean.astype(np.int64)
    # each clean suffix's key, to histogram the per-shard tables
    dm = np.arange(4, dtype=np.int64)
    keys = np.zeros(len(sa), np.int64)
    for j in range(k):
        keys = keys * 4 + dm[g.seq[sa + j]]
    per = -(-G // tp)
    halo = ((L + 15) // 16 + nw2) * 16
    gv_list, base_list, sa_list, lut2_list = [], [], [], []
    for t in range(tp):
        blo, bhi = t * per, min((t + 1) * per, G)
        base = max(0, (blo - halo) & ~15)
        gend = min(G, bhi + halo)
        gpack, gbad = pack_genome(g.seq[base:gend], nw2 + 1)
        gv_list.append(make_gview(gpack, gbad, nw2))
        base_list.append(base)
        inb = (sa >= blo) & (sa < bhi)
        sa_t = sa[inb]
        keys_t = keys[inb]
        lut_t = np.searchsorted(keys_t, np.arange(n_keys + 1))
        lo = lut_t[:-1]
        cnt = lut_t[1:] - lo
        sa_list.append(sa_t.astype(np.int32))
        lut2_list.append(np.stack([lo, cnt], axis=1).astype(np.int32))
    gvb = max(x.shape[0] for x in gv_list)
    mpad = max(len(x) for x in sa_list)
    gview_blocks = np.zeros((tp, gvb, 2 * nw2), np.uint32)
    sa_shards = np.zeros((tp, mpad), np.int32)
    for t in range(tp):
        gview_blocks[t, :gv_list[t].shape[0]] = gv_list[t]
        # pad rows mark every base invalid so they can never match
        gview_blocks[t, gv_list[t].shape[0]:, nw2:] = 0xFFFFFFFF
        sa_shards[t, :len(sa_list[t])] = sa_list[t]
    return (gview_blocks, np.asarray(base_list, np.int32), sa_shards,
            np.stack(lut2_list))


def pack_reads_sharded(reads: np.ndarray, dp: int):
    """[B, L] codes -> (2-bit [B, ceil(L/4)], N lists) for the dp-sharded
    passes: each dp shard's rows are packed alone, so its N list holds
    shard-local read indices, and the lists are concatenated in shard
    order, as JAX does.

    The passes cut that concatenation into dp equal row blocks (JAX's
    P("dp", None)). Each shard's list is as long as its own N count
    rounded up to a power of two >= 4,096, so when the lists differ in
    length a block holds rows of its neighbour's list: a shard then reads
    phantom Ns or loses its own. The port keeps JAX's behaviour (ROADMAP.md
    queue C, 'pack_reads_sharded mixes up the dp shards' N lists')."""
    from ..align.kalign import pack_reads_2bit
    B = reads.shape[0]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")
    per = B // dp
    packed, nlists = [], []
    for d in range(dp):
        p, nl = pack_reads_2bit(reads[d * per:(d + 1) * per])
        packed.append(p)
        nlists.append(nl)
    return np.concatenate(packed), np.concatenate(nlists)


def device_put_sharded_index_v3(mesh: Mesh, gview, sa_shards, lut2_shards,
                                key_lo):
    """Places the key-sharded pair-table index: gview replicated, the
    shards over "tp"."""
    return (device_put(mesh, gview),
            device_put(mesh, np.asarray(sa_shards).astype(np.int32),
                       ("tp",)),
            device_put(mesh, lut2_shards, ("tp",)),
            device_put(mesh, key_lo, ("tp",)))


def device_put_sharded_index_v5(mesh: Mesh, gview, lut4_shards, key_lo):
    """Places the key-sharded v5 index: gview replicated, the lut4 shards
    and key_lo over "tp"."""
    return (device_put(mesh, gview),
            device_put(mesh, lut4_shards, ("tp",)),
            device_put(mesh, key_lo, ("tp",)))


def device_put_sharded_index_pos(mesh: Mesh, gview_blocks, base, sa_shards,
                                 lut2_shards):
    """Places the position-sharded index of `shard_index_by_position`,
    every array over "tp" (JAX's callers place them by hand with these
    specs)."""
    return tuple(device_put(mesh, a, ("tp",))
                 for a in (gview_blocks, base, sa_shards, lut2_shards))


# --- the sharded passes -----------------------------------------------------

def _placed(mesh: Mesh, args: tuple, specs: tuple) -> list:
    return [device_put(mesh, a, s) for a, s in zip(args, specs)]


def _tp_merge(mesh: Mesh, d: int, parts: list, max_ml: int,
              with_overflow: bool = True):
    """The tp shards' (ids, mm[, overflow]) of dp shard d -> the
    finalize_fast stats of the whole index, on the shard's first
    device."""
    from ..ops.seed_extend_fast import finalize_fast
    home = mesh.devices[d, 0]
    ids = all_gather([p[0] for p in parts], home)
    mm = all_gather([p[1] for p in parts], home)
    out = finalize_fast(ids.T, mm.T, max_ml=max_ml)
    if with_overflow:
        out["overflow"] = psum([p[2] for p in parts], home) > 0
    return out


def _planes(cache: dict, dev, reads2b, nlist, read_len: int):
    """Word planes of one dp shard's reads on dev, built once a device."""
    from ..ops.seed_extend_v4 import words_from_2bit
    if dev not in cache:
        cache[dev] = words_from_2bit(reads2b, nlist, read_len)
    return cache[dev]


def make_sharded_align_pass_v3(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, n_compact: int,
                               n_extend: int, max_ml: int):
    """dp x tp key-sharded full-stats pass with JAX's v3 signature:
    fn(gview, sa_shards, lut2_shards, key_lo, reads [B, L] uint8) -> the
    fast_pass_v3 stats dict. Each dp shard's reads are packed to 2 bits
    and run the v4 core, as the single-device `fast_pass_v3` does.

    Exactly once across shards: a locus is emitted only by the shard
    owning its first exact window's key (the canonical test is a property
    of the read and the locus, not of the shard), so the merge is a
    concatenation."""
    from ..align.kalign import pack_reads_2bit
    from ..ops.seed_extend_v4 import _cands_core_v4
    _check_ceiling(genome_len)
    dp, tp = mesh.devices.shape
    specs = ((), ("tp",), ("tp",), ("tp",))

    def fn(gview, sa_shards, lut2_shards, key_lo, reads):
        gv, sa, l2, klo = _placed(mesh, (gview, sa_shards, lut2_shards,
                                         key_lo), specs)
        reads = reads.cpu().numpy() if isinstance(reads, torch.Tensor) \
            else np.asarray(reads)
        B, L = reads.shape
        if B % dp:
            raise ValueError(f"batch {B} not divisible by dp={dp}")
        per = B // dp
        outs = []
        for d in range(dp):
            r2b, nl = (torch.from_numpy(a) for a in
                       pack_reads_2bit(reads[d * per:(d + 1) * per]))
            cache, parts = {}, []
            for t in range(tp):
                dev = mesh.devices[d, t]
                planes = _planes(cache, dev, r2b.to(dev), nl.to(dev), L)
                parts.append(_cands_core_v4(
                    gv.local(d, t), sa.local(d, t)[0], l2.local(d, t)[0],
                    planes, genome_len=genome_len, offsets=offsets,
                    lut_k=lut_k, read_len=L, n_compact=n_compact,
                    n_extend=n_extend, key_lo=klo.local(d, t)[0]))
            outs.append(_tp_merge(mesh, d, parts, max_ml))
        return _gather_dp(mesh, outs)
    return fn


def make_sharded_align_pass_v4(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, read_len: int,
                               n_compact: int, n_extend: int, max_ml: int):
    """dp x tp key-sharded pass over the v4 core: fn(gview, sa_shards,
    lut2_shards, key_lo, reads2b, nlist) -> the fast_pass stats dict
    (low_mm / n_low / nxt_mm [B], hit_id / hit_mm [B, max_ml], overflow
    [B]). gview is replicated; sa_shards [tp, Mpad], lut2_shards [tp,
    keys_per, 2] and key_lo [tp] split over "tp"; reads2b [B, ceil(L/4)]
    and nlist (`pack_reads_sharded`) split over "dp". Exactly once as in
    the v3 pass: v4 keeps big-endian seed keys."""
    from ..ops.seed_extend_v4 import _cands_core_v4
    _check_ceiling(genome_len)
    dp, tp = mesh.devices.shape
    specs = ((), ("tp",), ("tp",), ("tp",), ("dp",), ("dp",))

    def fn(gview, sa_shards, lut2_shards, key_lo, reads2b, nlist):
        gv, sa, l2, klo, r2b, nl = _placed(
            mesh, (gview, sa_shards, lut2_shards, key_lo, reads2b, nlist),
            specs)
        outs = []
        for d in range(dp):
            cache, parts = {}, []
            for t in range(tp):
                dev = mesh.devices[d, t]
                planes = _planes(cache, dev, r2b.local(d, t),
                                 nl.local(d, t), read_len)
                parts.append(_cands_core_v4(
                    gv.local(d, t), sa.local(d, t)[0], l2.local(d, t)[0],
                    planes, genome_len=genome_len, offsets=offsets,
                    lut_k=lut_k, read_len=read_len, n_compact=n_compact,
                    n_extend=n_extend, key_lo=klo.local(d, t)[0]))
            outs.append(_tp_merge(mesh, d, parts, max_ml))
        return _gather_dp(mesh, outs)
    return fn


def make_sharded_align_pass_v5(mesh: Mesh, *, genome_len: int,
                               offsets: tuple, lut_k: int, read_len: int,
                               n_compact: int, n_extend: int, max_ml: int):
    """dp x tp key-sharded pass over the v5 core: fn(gview, lut4_shards,
    key_lo, reads2b, nlist) -> the fast_pass stats dict. lut4_shards
    [tp, keys_per, 8] and key_lo [tp] split over "tp", the reads over
    "dp". Reads with a seed bucket over P_POS inline positions are flagged
    overflow (summed over "tp") and escalate through the caller's ladder,
    as on one device."""
    from ..ops.seed_extend_v5 import _cands_core_v5
    _check_ceiling(genome_len)
    dp, tp = mesh.devices.shape
    specs = ((), ("tp",), ("tp",), ("dp",), ("dp",))

    def fn(gview, lut4_shards, key_lo, reads2b, nlist):
        gv, l4, klo, r2b, nl = _placed(
            mesh, (gview, lut4_shards, key_lo, reads2b, nlist), specs)
        outs = []
        for d in range(dp):
            cache, parts = {}, []
            for t in range(tp):
                dev = mesh.devices[d, t]
                planes = _planes(cache, dev, r2b.local(d, t),
                                 nl.local(d, t), read_len)
                parts.append(_cands_core_v5(
                    gv.local(d, t), l4.local(d, t)[0], planes,
                    genome_len=genome_len, offsets=offsets, lut_k=lut_k,
                    read_len=read_len, n_compact=n_compact,
                    n_extend=n_extend, key_lo=klo.local(d, t)[0]))
            outs.append(_tp_merge(mesh, d, parts, max_ml))
        return _gather_dp(mesh, outs)
    return fn


_POS_SPECS = (("tp",), ("tp",), ("tp",), ("tp",))


def _pos_mate(mesh: Mesh, d: int, index: list, r2b, nl, core,
              read_len: int, max_ml: int, with_overflow: bool = True):
    """One mate (or the single end) of dp shard d against every position
    shard: core(gview block, sa shard, lut2 shard, base, planes) on each
    tp cell, then the tp merge."""
    gv, base, sa, l2 = index
    cache, parts = {}, []
    for t in range(mesh.devices.shape[1]):
        dev = mesh.devices[d, t]
        planes = _planes(cache, dev, r2b.local(d, t), nl.local(d, t),
                         read_len)
        parts.append(core(gv.local(d, t)[0], sa.local(d, t)[0],
                          l2.local(d, t)[0], base.local(d, t)[0], planes))
    return _tp_merge(mesh, d, parts, max_ml, with_overflow)


def _v4_pos_core(**kw):
    """The v4 core against a position shard: key_lo 0 (every shard holds
    the whole key space), gview_base the shard's base."""
    from ..ops.seed_extend_v4 import _cands_core_v4

    def core(gview_b, sa_s, lut2_s, base_s, planes):
        return _cands_core_v4(gview_b, sa_s, lut2_s, planes, key_lo=0,
                              gview_base=base_s, **kw)
    return core


def make_sharded_align_pass_pos(mesh: Mesh, *, genome_len: int,
                                offsets: tuple, lut_k: int, read_len: int,
                                n_compact: int, n_extend: int,
                                max_ml: int):
    """dp x tp pass over position-sharded genome blocks
    (`shard_index_by_position`): fn(gview_blocks, base, sa_shards,
    lut2_shards, reads2b, nlist) -> the fast_pass stats dict; the index
    arrays split over "tp", the reads over "dp"."""
    _check_ceiling(genome_len)
    dp = mesh.devices.shape[0]
    core = _v4_pos_core(genome_len=genome_len, offsets=offsets,
                        lut_k=lut_k, read_len=read_len, n_compact=n_compact,
                        n_extend=n_extend)

    def fn(gview_blocks, base, sa_shards, lut2_shards, reads2b, nlist):
        index = _placed(mesh, (gview_blocks, base, sa_shards, lut2_shards),
                        _POS_SPECS)
        r2b, nl = _placed(mesh, (reads2b, nlist), (("dp",), ("dp",)))
        return _gather_dp(mesh, [_pos_mate(mesh, d, index, r2b, nl, core,
                                           read_len, max_ml)
                                 for d in range(dp)])
    return fn


def make_sharded_pe_pass_pos(mesh: Mesh, *, genome_len: int,
                             offsets: tuple, lut_k: int, read_len: int,
                             n_compact: int, n_extend: int, max_ml: int,
                             max_tot: int, mm_delta: int, min_ins: int,
                             max_ins: int):
    """dp x tp paired-end pass over position-sharded genome blocks:
    fn(gview_blocks, base, sa_shards, lut2_shards, starts, r2b1, nl1,
    r2b2, nl2) -> [B, 12] int32 pair rows (align/pe.py's layout, not
    wire-packed). Both mates' candidates are merged over "tp" and
    finalized, then every dp shard pairs them (`_pair_rows`), since
    pairing needs both mates' whole hit lists. Rows of pairs that do not
    overflow equal the single-device `pe_pass_packed` rows."""
    from ..ops.pe_packed import _pair_rows
    _check_ceiling(genome_len)
    dp = mesh.devices.shape[0]
    core = _v4_pos_core(genome_len=genome_len, offsets=offsets,
                        lut_k=lut_k, read_len=read_len, n_compact=n_compact,
                        n_extend=n_extend)
    pair_kw = dict(L1=read_len, L2=read_len, max_tot=max_tot,
                   mm_delta=mm_delta, min_ins=min_ins, max_ins=max_ins)

    def fn(gview_blocks, base, sa_shards, lut2_shards, starts, r2b1, nl1,
           r2b2, nl2):
        index = _placed(mesh, (gview_blocks, base, sa_shards, lut2_shards),
                        _POS_SPECS)
        st = device_put(mesh, starts)
        m1 = _placed(mesh, (r2b1, nl1), (("dp",), ("dp",)))
        m2 = _placed(mesh, (r2b2, nl2), (("dp",), ("dp",)))
        outs = []
        for d in range(dp):
            f1 = _pos_mate(mesh, d, index, *m1, core, read_len, max_ml)
            f2 = _pos_mate(mesh, d, index, *m2, core, read_len, max_ml)
            o1, o2 = f1.pop("overflow"), f2.pop("overflow")
            outs.append(_pair_rows(f1, f2, o1, o2, st.local(d, 0),
                                   **pair_kw))
        return _gather_dp(mesh, outs)
    return fn


def make_sharded_deep_pe_pass_pos(mesh: Mesh, *, genome_len: int,
                                  offsets: tuple, lut_k: int,
                                  read_len: int, n_blocks: int,
                                  block_size: int, max_ml: int,
                                  max_tot: int, mm_delta: int,
                                  min_ins: int, max_ins: int,
                                  skip_bucket: int = 5000,
                                  n_sel: int | None = 4):
    """Position-sharded deep tier: both mates take the capped deep
    exploration against each genome block, merged over "tp", finalized
    and paired on every dp shard; the same arguments and [B, 12] rows as
    `make_sharded_pe_pass_pos`, and no overflow flags. Each locus lives in
    one block, so it is emitted once; the bucket caps and the rarest-K
    choice apply to each shard's own bucket counts, so the shards together
    explore at least what one device's capped pass explores."""
    from ..ops.pe_packed import _pair_rows
    from ..ops.seed_extend_deep import deep_cands_planes
    _check_ceiling(genome_len)
    dp = mesh.devices.shape[0]
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              read_len=read_len, n_blocks=n_blocks, block_size=block_size,
              skip_bucket=skip_bucket, n_sel=n_sel)

    def core(gview_b, sa_s, lut2_s, base_s, planes):
        return deep_cands_planes(gview_b, sa_s, lut2_s, planes,
                                 gview_base=base_s, **kw)
    pair_kw = dict(L1=read_len, L2=read_len, max_tot=max_tot,
                   mm_delta=mm_delta, min_ins=min_ins, max_ins=max_ins)

    def fn(gview_blocks, base, sa_shards, lut2_shards, starts, r2b1, nl1,
           r2b2, nl2):
        index = _placed(mesh, (gview_blocks, base, sa_shards, lut2_shards),
                        _POS_SPECS)
        st = device_put(mesh, starts)
        m1 = _placed(mesh, (r2b1, nl1), (("dp",), ("dp",)))
        m2 = _placed(mesh, (r2b2, nl2), (("dp",), ("dp",)))
        outs = []
        for d in range(dp):
            f1 = _pos_mate(mesh, d, index, *m1, core, read_len, max_ml,
                           False)
            f2 = _pos_mate(mesh, d, index, *m2, core, read_len, max_ml,
                           False)
            no = torch.zeros(f1["low_mm"].shape[0], dtype=torch.bool,
                             device=f1["low_mm"].device)
            outs.append(_pair_rows(f1, f2, no, no, st.local(d, 0),
                                   **pair_kw))
        return _gather_dp(mesh, outs)
    return fn
