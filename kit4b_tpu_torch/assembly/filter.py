"""Read filtering (ngskit4b `filter` / CArtefactReduce equivalent): the
port's copy of kit4b_tpu/assembly/filter.py, with the near-duplicate pass
on an explicit device.

Phases mirror CArtefactReduce::Process (ngskit4b/ArtefactReduce.cpp:893):
  1. load + trims (store.from_records), with checkpoint probe/save
     (ArtefactReduce.cpp:969-982);
  2. duplicate removal — exact sequence dups for SE, exact pair dups for PE
     (IdentifyDuplicates:1548 / RemoveDuplicates:1350), via lexicographic
     sort of fixed-width key matrices instead of index probes + CAS flags;
  3. overlap-support filter — a read must be overlapped by other reads on
     its flanks or it is treated as containing sequencer errors and removed
     (IdentifyOverlaps:1815 / RemoveNonOverlaps:1372), scored on the host
     by the same corpus index the assembler uses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from .store import FLAG_DELETED, FLAG_DUP, FLAG_NOOVL, SeqStore


@dataclass
class FilterParams:
    dedup: bool = True
    dedup_pe: bool = True           # pair-level dedup when PE
    near_dup_subs: int = 0          # >0: also flag near-dups (<= subs)
    min_overlap_pct: int = 70       # flank overlap support requirement
    overlap_passes: int = 1         # iterative support passes
    max_subs_per_100: int = 2


def _dup_mask(keys: np.ndarray) -> np.ndarray:
    """True for every row that is a duplicate of an earlier identical row."""
    if len(keys) == 0:
        return np.zeros(0, bool)
    order = np.lexsort(keys.T[::-1])
    sorted_keys = keys[order]
    same = np.concatenate([[False],
                           (sorted_keys[1:] == sorted_keys[:-1]).all(axis=1)])
    dup = np.zeros(len(keys), bool)
    dup[order] = same
    return dup


def mark_duplicates(store: SeqStore, pe: bool = False) -> int:
    """Flag exact duplicates (sequence-identical; for PE, identical pairs).
    Returns number flagged."""
    live = np.nonzero(store.live_mask())[0]
    if len(live) == 0:
        return 0
    lens = store.lengths
    uniform = lens[live].min() == lens[live].max()

    def seq_rows(idxs, width):
        """[n, width] key rows; uniform lengths gather via a sliding
        view (one row index per read instead of a per-read Python
        loop), ragged lengths fall back to the loop."""
        if uniform and width == int(lens[idxs[0]]):
            sw = np.lib.stride_tricks.sliding_window_view(
                np.concatenate([store.seq,
                                np.full(width, 255, np.uint8)]), width)
            return sw[store.starts[idxs]]
        rows = np.full((len(idxs), width), 255, np.uint8)
        for r, i in enumerate(idxs):
            a = store.get(int(i))
            rows[r, :len(a)] = a
        return rows

    if pe and store.mate is not None:
        firsts = np.asarray([i for i in live if store.mate[i] > i],
                            np.int64)
        if not len(firsts):
            return 0
        mates = store.mate[firsts]
        wa = int(lens[firsts].max())
        wb = int(lens[mates].max())
        keys = np.concatenate(
            [lens[firsts][:, None].astype(np.uint8),
             seq_rows(firsts, wa),
             np.full((len(firsts), 1), 254, np.uint8),
             seq_rows(mates, wb)], axis=1)
        dup = _dup_mask(keys)
        store.flags[firsts[dup]] |= FLAG_DUP | FLAG_DELETED
        store.flags[mates[dup]] |= FLAG_DUP | FLAG_DELETED
        return 2 * int(dup.sum())
    width = int(lens[live].max())
    keys = np.concatenate([lens[live][:, None].astype(np.uint8),
                           seq_rows(live, width)], axis=1)
    dup = _dup_mask(keys)
    store.flags[live[dup]] |= FLAG_DUP | FLAG_DELETED
    return int(dup.sum())


def mark_near_duplicates(store: SeqStore, max_subs: int = 2,
                         batch: int = 8192, cand: int = 32,
                         device="cuda") -> int:
    """Flag near-duplicates: same-length reads identical up to max_subs
    substitutions (CArtefactReduce::IdentifyDuplicates near-dup mode,
    ArtefactReduce.cpp:1548). Device-scored: each read's prefix k-mer is
    probed against the read-corpus index and full-length compares count
    mismatches; of each discovered pair the lower store id is retained.
    Sense-strand only (run after exact dedup, which handles rc pairs via
    the assembler corpus when enabled).

    The corpus, its suffix index and its genome view are built once on
    `device` (the view by `make_gview_device` from the 2-bit packed
    corpus); each batch of `batch` queries is one `_overlap_pass`, and the
    per-batch host work (the valid mask, the same-length test,
    `kill[max(a, b)]`, the mate propagation) stays numpy as in the JAX
    package."""
    from ..index.sfx_index import SfxIndex
    from ..ops.extend_packed import pack_genome
    from ..ops.seed_extend_fast import make_gview_device
    from .overlap import INT32_MAX, _overlap_pass, corpus_genome

    live = np.nonzero(store.live_mask())[0]
    if len(live) < 2:
        return 0
    dev = resolve(device)
    g, live_ids = corpus_genome(store, with_rc=False)
    idx = SfxIndex.build(g)
    genome_d = torch.from_numpy(g.seq).to(dev)
    sa_d = torch.from_numpy(idx.sa_clean.astype(np.int32)).to(dev)
    lut_d = torch.from_numpy(idx.lut.astype(np.int32)).to(dev)
    starts, lengths = g.starts, g.lengths
    ends_d = torch.from_numpy((starts + lengths).astype(np.int32)).to(dev)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    win = int(lengths.max())
    nw2 = (win + 15) // 16 + 1
    gpack, gbad = pack_genome(g.seq, nw2 + 1)
    gview_d = make_gview_device(gpack, gbad, nw2, dev)
    n = len(g.names)
    kill = np.zeros(n, bool)
    for s in range(0, n, batch):
        q_ids = np.arange(s, min(s + batch, n))
        nb = len(q_ids)
        qs, ql = starts[q_ids], lengths[q_ids]
        if nb < batch:
            qs = np.concatenate([qs, np.zeros(batch - nb, np.int64)])
            ql = np.concatenate([ql, np.zeros(batch - nb, np.int64)])
        pos, mm = _overlap_pass(gview_d, genome_d, sa_d, lut_d,
                                starts_d, ends_d,
                                torch.from_numpy(qs).to(dev),
                                torch.from_numpy(ql).to(dev),
                                lut_k=idx.lut_k, cand=cand, win=win)
        pos = pos.cpu().numpy()[:nb]
        mm = mm.cpu().numpy()[:nb]
        # vectorized same-length whole-read near-dup detection
        valid = (pos != INT32_MAX) & (mm <= max_subs)
        b_ids = np.broadcast_to(q_ids[:, None], pos.shape)
        a_ids = np.searchsorted(starts, np.where(valid, pos, 0),
                                side="right") - 1
        valid &= (a_ids != b_ids) \
            & (np.where(valid, pos, -1) == starts[a_ids]) \
            & (lengths[a_ids] == lengths[b_ids])
        kill[np.maximum(a_ids, b_ids)[valid]] = True
    flagged = live_ids[np.nonzero(kill)[0]]
    store.flags[flagged] |= FLAG_DUP | FLAG_DELETED
    if store.mate is not None:
        for i in flagged:
            m = store.mate[i]
            if m >= 0:
                store.flags[m] |= FLAG_DUP | FLAG_DELETED
    return int(kill.sum())


def mark_unsupported(store: SeqStore, params: FilterParams) -> int:
    """Flag reads lacking overlap support from any other read.

    A read passes when some other read overlaps its prefix by at least
    min_overlap_pct of its length (the prefix-overlap corpus pass covers the
    5' flank; the revcomp corpus entry covers the 3' flank symmetrically).
    """
    from .overlap import CorpusIndex
    live = np.nonzero(store.live_mask())[0]
    n_live = len(live)
    if n_live == 0:
        return 0
    min_len = int(store.lengths[live].min())
    min_ovl = max(16, min_len * params.min_overlap_pct // 100)
    idx = CorpusIndex([store.get(int(i)) for i in live])
    edges, contained = idx.probe(
        range(n_live), min_overlap=min_ovl,
        max_subs_per_100=params.max_subs_per_100)
    supported = np.zeros(n_live, bool)
    if len(edges):
        supported[edges[:, 0]] = True
        supported[edges[:, 2]] = True
    if len(contained):
        supported[contained[:, 0]] = True
        supported[contained[:, 1]] = True
    bad = np.nonzero(~supported)[0]
    store.flags[live[bad]] |= FLAG_NOOVL | FLAG_DELETED
    return len(bad)


def filter_assemble(store: SeqStore, fparams: "FilterParams | None" = None,
                    aparams=None, progress=None, timings: dict | None = None):
    """Fused filter -> assemb pipeline (round 5): ONE CorpusIndex and
    ONE full-corpus probe serve both the overlap-support filter
    (IdentifyOverlaps, ArtefactReduce.cpp:1815) and assembly pass 1 —
    the separate-phase flow builds the same index twice and probes the
    same corpus twice. Returns the contig SeqStore; `timings` (optional
    dict) receives 'filter_s' / 'assemb_s' phase splits. The standalone
    artefact_reduce / assemble remain for the checkpointed CLI flow."""
    import time as _time

    from .assemble import AssembleParams, _assemble_core
    from .overlap import CorpusIndex
    fp = fparams or FilterParams()
    ap = aparams or AssembleParams()
    t0 = _time.time()
    pe = store.mate is not None
    if fp.dedup:
        n = mark_duplicates(store, pe=pe and fp.dedup_pe)
        if progress:
            progress("duplicates", n)
    store = store.compact()
    live = np.nonzero(store.live_mask())[0]
    idx = CorpusIndex([store.get(int(i)) for i in live])
    n_live = len(live)
    floor = ap.min_overlap_final
    min_len = int(store.lengths[live].min()) if n_live else 0
    sup_ovl = max(16, min_len * fp.min_overlap_pct // 100)
    edges, cont = idx.probe(range(n_live),
                            min_overlap=min(floor, sup_ovl),
                            max_subs_per_100=ap.max_subs_per_100)
    # overlap-support rule at ITS threshold from the shared edge set
    supported = np.zeros(n_live, bool)
    if len(edges):
        strong = edges[edges[:, 4] >= sup_ovl]
        supported[strong[:, 0]] = True
        supported[strong[:, 2]] = True
    if len(cont):
        supported[cont[:, 0]] = True
        supported[cont[:, 1]] = True
    n_unsup = 0
    for s in np.nonzero(~supported)[0]:
        idx.kill(int(s))
        n_unsup += 1
    if progress:
        progress("unsupported", n_unsup)
    if timings is not None:
        timings["filter_s"] = _time.time() - t0
        timings["n_unsupported"] = n_unsup
    t0 = _time.time()
    amask = np.asarray(idx.alive, bool)
    if len(edges):
        edges = edges[amask[edges[:, 0]] & amask[edges[:, 2]]
                      & (edges[:, 4] >= floor)]
    # containments among survivors apply inside the core via the pool?
    # no — apply them now (assembly pass 1 would have)
    pairs = []
    if store.mate is not None:
        lmap = {int(v): u for u, v in enumerate(live)}
        for u, v in enumerate(live):
            m = int(store.mate[int(v)])
            mu = lmap.get(m, -1) if m >= 0 else -1
            if mu > u and amask[u] and amask[mu]:
                pairs.append((u, mu))
    for inner, outer in cont.tolist():
        if inner != outer and idx.alive[inner] and idx.alive[outer]:
            li = len(idx.seqs[inner])
            lo_ = len(idx.seqs[outer])
            if lo_ > li or (lo_ == li and outer < inner):
                idx.kill(inner)
    out = _assemble_core(idx, pairs, ap, pool0=edges)
    if timings is not None:
        timings["assemb_s"] = _time.time() - t0
    return out


def artefact_reduce(store: SeqStore, params: FilterParams | None = None,
                    checkpoint: str | None = None, progress=None,
                    device="cuda") -> SeqStore:
    """Full filter pipeline; returns compacted store. Only the
    near-duplicate pass (params.near_dup_subs > 0) touches `device`."""
    p = params or FilterParams()
    pe = store.mate is not None
    if p.dedup:
        n = mark_duplicates(store, pe=pe and p.dedup_pe)
        if progress:
            progress("duplicates", n)
    if p.near_dup_subs > 0:
        store = store.compact()
        n = mark_near_duplicates(store, p.near_dup_subs, device=device)
        if progress:
            progress("near-duplicates", n)
    store = store.compact()
    for i in range(p.overlap_passes):
        n = mark_unsupported(store, p)
        if progress:
            progress(f"unsupported pass {i+1}", n)
        store = store.compact()
        if n == 0:
            break
    if checkpoint:
        store.save(checkpoint)
    return store
