"""Paired-end kalign: pairing over per-mate multiloci hits, on PyTorch.

Port of kit4b_tpu/align/pe.py's packed path, the reference's PE handling
(ngskit4b/KAligner.cpp:10173-10238 AcceptProvPE cross-product over
multiloci hits; :2944 ProcessPairedEnds; :3333 AlignPartnerRead orphan
rescue):

  - both mates are aligned on the device by one pass, `pe_pass_packed`,
    keeping up to max_ml loci each;
  - a pair is accepted when its mates hit one chromosome on opposite
    strands, the forward mate leftmost, with the outer insert within
    [pair_min_len, pair_max_len] (-d/-D); the lowest combined mismatch
    count wins, and a tie on distinct loci rejects the pair as multi;
  - pairs whose candidates overflow the pass's tiers escalate on the host's
    orders: rescue from a uniquely aligned mate over the insert window
    (`window_scan_pe`), then the deep capped tier (`deep_pe_pass_planes`)
    in stages; the deep tier is total, so no pair is left unresolved;
  - orphan rescue (pemode 1/3): when one mate aligned uniquely and the
    other found nothing, the partner is looked for over the insert window
    around the anchor on the expected strand.

PE modes (-U): 1 rescue orphans, 2 no rescue, 3/4 as 1/2 but orphans fall
back to SE acceptance.

Batches of `batch_size` pairs run in groups of `superbatch`: a group's
passes are submitted before the previous group is drained, so the device
queue never runs dry while the host resolves a group. Uploads go from
pinned host buffers without waiting for the device.

Mates of unequal length (in any pair, or of lengths that differ between
pairs) take the host full-stats path, as in JAX: each mate list is aligned
by `KAligner.align_batch(return_raw=True)` (`fast_pass_v3`, the rescues the
aligner has on), the pairs are formed on the host from both mates' hit
lists (`_pair`) and an orphan is looked for over the insert window by a
numpy scan (`_rescue`).

Not ported (ROADMAP.md queue A item 18, genomes whose int32 locus ids
wrap): the byte-tensor `pe_pass` with its escalation loop
(`_pe_pass_subset`, `_drain_device`, `PeAligner(escalation=)`), which JAX
takes only past that ceiling, and the host-probe window scans
`window_scan` and `window_scan_packed` that its rescue reaches.
"""
from __future__ import annotations

import bisect
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import dna, native
from ..io.fasta import SeqRecord
from ..io.sam import (FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_PROPER_PAIR, FLAG_REVERSE,
                      FLAG_SECOND, FLAG_UNMAPPED, seq_qual_for_strand)
from ..ops import pe_packed, seed_extend_fast
from ..ops.pe_packed import (PAIR_ACCEPT, PAIR_MULTI, PAIR_NONE,  # noqa: F401
                             PAIR_OVERFLOW, unpack_rows12)
from ..ops.seed_extend_deep import deep_pe_pass_planes
from ..ops.seed_extend_v4 import words_from_2bit
from . import kalign as _k

INT32_MAX = _k.INT32_MAX

NAR_PE_ACCEPTED = _k.NAR_ACCEPTED
NAR_PE_NOPAIR = "nopair"
NAR_PE_INSERT = "badinsert"

# pair rows each escalation stage takes, as PeAligner.stage_rows counts
# them: rows past the pass's in-graph tiers, rows marked unpairable
# without further work, rows the insert-window rescue takes before the
# deep tier, rows of deep stage 1, rows rescued from deep stage 1's
# anchors, rows of deep stage 2b and 3, and PAIR_NONE rows the orphan
# rescue scans
STAGES = ("overflow", "dead", "rescue_before_deep", "deep1",
          "rescue_after_deep", "deep2b", "deep3", "orphan_rescue")


@dataclass
class PePair:
    nar: str                      # accepted / nopair / badinsert / ...
    r1: _k.AlignResult | None = None
    r2: _k.AlignResult | None = None
    tlen: int = 0                 # observed insert (outer distance)
    rescued: int = 0              # 1 or 2 if that mate was orphan-rescued


def _hits_of(hit_ids, hit_mms, max_tot_mm):
    """Usable loci for pairing: all reported hits with mm <= budget, as
    (pos, strand, mm)."""
    out = []
    for hid, hmm in zip(hit_ids, hit_mms):
        if hid == INT32_MAX or hmm > max_tot_mm:
            continue
        out.append((int(hid) >> 1, int(hid) & 1, int(hmm)))
    return out


class _LazyRecs:
    """Sequence view over an [N, L] code matrix that materialises
    SeqRecord objects only where individually indexed — the batch paths
    slice the matrix."""

    def __init__(self, codes, names):
        self.codes_matrix = np.ascontiguousarray(codes, dtype=np.uint8)
        self._names = names if isinstance(names, list) else list(names)

    def __len__(self):
        return len(self.codes_matrix)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return SeqRecord(self._names[i], "", self.codes_matrix[i])


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without waiting for it: a pinned copy and a
    non-blocking transfer on CUDA (a copy from pageable memory waits for
    the stream and would serialise the groups)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class PeAligner:
    """Paired-end aligner over a base KAligner, on the aligner's device."""

    def __init__(self, aligner: _k.KAligner, *,
                 pair_min_len: int = 100, pair_max_len: int = 1000,
                 pe_mode: int = 2):
        self.al = aligner
        self.min_len = pair_min_len
        self.max_len = pair_max_len
        self.pe_mode = pe_mode
        # in-graph tier-2 of the packed pass (E slots, NC, NS); None
        # leaves every overflowed pair to the host's escalation
        self.tier2 = (1024, 192, 96)
        self.superbatch = 4
        self.stage_rows = dict.fromkeys(STAGES, 0)

    def _count(self, stage: str, n: int) -> None:
        self.stage_rows[stage] += int(n)

    def align_pairs_arrays(self, codes1: np.ndarray, codes2: np.ndarray,
                           names1=None, names2=None):
        """Array-native align_pairs: [N, L] uint8 code matrices in,
        (rec1, rec2, PePair) stream out; records are materialised lazily
        from matrix rows."""
        n = len(codes1)
        recs1 = _LazyRecs(codes1, names1 or (f"r1_{i}" for i in range(n)))
        recs2 = _LazyRecs(codes2, names2 or (f"r2_{i}" for i in range(n)))
        yield from self._align_pairs_device(recs1, recs2)

    def align_pairs(self, recs1, recs2):
        """Align paired record lists; returns a (rec1, rec2, PePair)
        stream. Pairs whose mates all share one length run the device
        pairing pass; any other mix takes the host full-stats path."""
        recs1, recs2 = list(recs1), list(recs2)
        assert len(recs1) == len(recs2), "PE file length mismatch"
        lens = {(len(a.codes), len(b.codes)) for a, b in zip(recs1, recs2)}
        if len(lens) == 1 and len(recs1[0].codes) == len(recs2[0].codes):
            return self._align_pairs_device(recs1, recs2)
        return self._align_pairs_host(recs1, recs2)

    def _align_pairs_host(self, recs1, recs2):
        for r1, r2, a1, a2 in zip(recs1, recs2, self._align_all(recs1),
                                  self._align_all(recs2)):
            yield r1, r2, self._pair(r1, r2, a1, a2)

    def _align_all(self, recs):
        """Align records preserving order; returns a list of
        (AlignResult, hit_ids, hit_mms, max_tot_mm). Each batch_size chunk
        is aligned by read length; JAX pads each length's rows to
        batch_size for its compiled shapes, which no row's answer depends
        on, so the port aligns the rows alone."""
        out = []
        B = self.al.batch_size
        for chunk_start in range(0, len(recs), B):
            chunk = recs[chunk_start:chunk_start + B]
            by_len: dict[int, list[int]] = {}
            for i, r in enumerate(chunk):
                by_len.setdefault(len(r.codes), []).append(i)
            chunk_out: list = [None] * len(chunk)
            for L, idxs in by_len.items():
                arr = np.stack([chunk[i].codes for i in idxs])
                results, raw = self.al.align_batch(arr, return_raw=True)
                _, max_tot_mm = self.al.schedule_for(L)
                for j, i in enumerate(idxs):
                    chunk_out[i] = (results[j], raw["hit_id"][j],
                                    raw["hit_mm"][j], max_tot_mm)
            out.extend(chunk_out)
        return out

    def _same_chrom(self, p1: int, p2: int) -> bool:
        g = self.al.index.genome
        c1 = np.searchsorted(g.starts, p1, side="right")
        c2 = np.searchsorted(g.starts, p2, side="right")
        return c1 == c2

    def _valid_pair(self, h1, h2, L1: int, L2: int):
        """Orientation + insert check of two (pos, strand, mm) hits.
        Returns the insert length or None. Default PE library (FR):
        forward mate leftmost, reverse mate rightmost; insert = outer
        distance."""
        p1, s1, _ = h1
        p2, s2, _ = h2
        if s1 == s2:
            return None
        if not self._same_chrom(p1, p2):
            return None
        if s1 == 0:  # mate1 forward, mate2 reverse: p1 <= p2 end
            left, right_end = p1, p2 + L2
            if p2 < p1:
                return None
        else:        # mate2 forward
            left, right_end = p2, p1 + L1
            if p1 < p2:
                return None
        insert = right_end - left
        if not (self.min_len <= insert <= self.max_len):
            return None
        return insert

    def _pair(self, rec1, rec2, a1, a2) -> PePair:
        """AcceptProvPE over both mates' hit lists (KAligner.cpp:10173):
        the lowest combined mismatch count of the valid combinations,
        unique in its loci; else the orphan rescue and the orphan-as-SE
        fallback of the pe mode."""
        res1, hid1, hmm1, mtm1 = a1
        res2, hid2, hmm2, mtm2 = a2
        L1, L2 = len(rec1.codes), len(rec2.codes)
        h1 = _hits_of(hid1, hmm1, mtm1)
        h2 = _hits_of(hid2, hmm2, mtm2)

        best = None
        best_score = None
        n_best = 0
        for c1 in h1:
            for c2 in h2:
                ins = self._valid_pair(c1, c2, L1, L2)
                if ins is None:
                    continue
                score = c1[2] + c2[2]
                if best_score is None or score < best_score:
                    best, best_score, n_best = (c1, c2, ins), score, 1
                elif score == best_score and (c1[0], c2[0]) != (
                        best[0][0], best[1][0]):
                    n_best += 1
        if best is not None and n_best == 1:
            (p1, s1, m1), (p2, s2, m2), ins = best
            return PePair(
                NAR_PE_ACCEPTED,
                _k.AlignResult(_k.NAR_ACCEPTED, strand=s1, pos=p1, mm=m1,
                               n_low=1),
                _k.AlignResult(_k.NAR_ACCEPTED, strand=s2, pos=p2, mm=m2,
                               n_low=1),
                tlen=ins)
        if best is not None:
            return PePair(NAR_PE_NOPAIR)

        # orphan rescue (pemode 1/3): anchor on a uniquely aligned mate
        if self.pe_mode in (1, 3):
            pair = self._rescue(rec1, rec2, res1, res2, h1, h2, L1, L2,
                                mtm1, mtm2)
            if pair is not None:
                return pair

        # orphan-as-SE fallback (pemode 3/4)
        if self.pe_mode in (3, 4):
            r1 = res1 if res1.nar == _k.NAR_ACCEPTED else None
            r2 = res2 if res2.nar == _k.NAR_ACCEPTED else None
            if r1 or r2:
                return PePair(NAR_PE_NOPAIR, r1, r2)
        return PePair(NAR_PE_NOPAIR)

    def _rescue(self, rec1, rec2, res1, res2, h1, h2, L1, L2, mtm1, mtm2):
        """AlignPartnerRead equivalent (KAligner.cpp:3333-3440): scan the
        insert window around the unique anchor for the missing mate."""
        if res1.nar == _k.NAR_ACCEPTED and not h2:
            anchor, orphan, Lo, mtm, who = res1, rec2, L2, mtm2, 2
        elif res2.nar == _k.NAR_ACCEPTED and not h1:
            anchor, orphan, Lo, mtm, who = res2, rec1, L1, mtm1, 1
        else:
            return None
        g = self.al.index.genome.seq
        # expected window: opposite strand within max insert of the anchor
        La = L1 if who == 2 else L2
        if anchor.strand == 0:
            lo = anchor.pos + self.min_len - Lo
            hi = anchor.pos + self.max_len - Lo
            want_strand = 1
        else:
            lo = anchor.pos + La - self.max_len
            hi = anchor.pos + La - self.min_len
            want_strand = 0
        lo = max(0, lo)
        hi = min(len(g) - Lo, hi)
        if hi < lo:
            return None
        probe = (orphan.codes if want_strand == 0
                 else dna.revcomp(orphan.codes))
        span = g[lo:hi + Lo]
        wins = np.lib.stride_tricks.sliding_window_view(span, Lo)
        mm = (wins != probe).sum(axis=1)
        best = int(mm.min())
        if best > mtm:
            return None
        cands = np.nonzero(mm == best)[0]
        if len(cands) != 1:
            return None
        opos = lo + int(cands[0])
        o_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=want_strand,
                               pos=opos, mm=best, n_low=1)
        if who == 2:
            r1, r2 = anchor, o_res
        else:
            r1, r2 = o_res, anchor
        ins = self._valid_pair((r1.pos, r1.strand, r1.mm),
                               (r2.pos, r2.strand, r2.mm), L1, L2)
        if ins is None:
            return None
        return PePair(NAR_PE_ACCEPTED, r1, r2, tlen=ins, rescued=who)

    def _align_pairs_device(self, recs1, recs2):
        al = self.al
        g = al.index.genome
        dev = al.device
        L = len(recs1[0].codes)
        _, max_tot = al.schedule_for(L)
        gview, sa, _, lut2 = al._device_for(L)
        starts_d = torch.from_numpy(np.asarray(g.starts, np.int32)).to(dev)
        B = al.batch_size
        offsets = al._offsets_for(L, max_tot)
        pkw = dict(genome_len=len(g.seq), offsets=offsets,
                   lut_k=al.index.lut_k, read_len=L,
                   n_compact=al.n_compact, n_extend=al.n_extend,
                   max_ml=al.max_ml, max_tot=max_tot,
                   mm_delta=al.mm_delta, min_ins=self.min_len,
                   max_ins=self.max_len,
                   tier2=self.tier2 if self.tier2 is None
                   else (min(B, self.tier2[0]),) + tuple(self.tier2[1:]),
                   tier3=None)
        # the escalation stages' context
        self._pctx = dict(gview=gview, sa=sa, lut2=lut2, starts_d=starts_d,
                          L=L, max_tot=max_tot, offsets=offsets)

        def submit(i0):
            if isinstance(recs1, _LazyRecs):
                a1 = recs1.codes_matrix[i0:i0 + B]
                a2 = recs2.codes_matrix[i0:i0 + B]
            else:
                a1 = np.stack([r.codes for r in recs1[i0:i0 + B]])
                a2 = np.stack([r.codes for r in recs2[i0:i0 + B]])
            if len(a1) < B:
                a1 = np.concatenate(
                    [a1, np.repeat(a1[:1], B - len(a1), axis=0)])
                a2 = np.concatenate(
                    [a2, np.repeat(a2[:1], B - len(a2), axis=0)])
            r2b1, nl1 = _k.pack_reads_2bit(a1)
            r2b2, nl2 = _k.pack_reads_2bit(a2)
            handles = tuple(_upload(a, dev) for a in (r2b1, nl1, r2b2, nl2))
            return pe_packed.pe_pass_packed(gview, sa, lut2, starts_d,
                                            *handles, **pkw), handles

        # superbatch groups: a group's passes are submitted, then the
        # previous group is drained, its escalation pooled over the group
        SB = self.superbatch
        starts_idx = list(range(0, len(recs1), B))
        groups = [starts_idx[i:i + SB]
                  for i in range(0, len(starts_idx), SB)]
        pending_group = None
        for grp in groups:
            subs = [(i0, submit(i0)) for i0 in grp]
            if pending_group is not None:
                yield from self._drain_group(pending_group, recs1, recs2,
                                             max_tot)
            pending_group = subs
        if pending_group is not None:
            yield from self._drain_group(pending_group, recs1, recs2,
                                         max_tot)

    def _drain_group(self, subs, recs1, recs2, max_tot):
        """Resolve one superbatch group: its batches' rows concatenate
        into one pooled escalation (group row r is record i0 + r)."""
        B = self.al.batch_size
        i0g = subs[0][0]
        allout = unpack_rows12(torch.cat(
            [rows for _, (rows, _) in subs]).cpu().numpy())
        outs = []
        for si, (i0, _) in enumerate(subs):
            n = min(B, len(recs1) - i0)
            outs.append(allout[si * B:si * B + n])
        out = np.concatenate(outs)
        yield from self._resolve_rows(out, len(out), i0g,
                                      [h for _, (_, h) in subs], recs1,
                                      recs2, max_tot)

    # deep-tier E quanta: escalated-pair subsets pad to these shapes, so a
    # few shapes serve every call (the 16384 quantum lets a whole
    # superbatch group's dual rows run as one call)
    _DEEP_QUANTA = (256, 1024, 4096, 16384)
    # deep candidate budget (n_blocks, block_size) by sensitivity mode:
    # repeat-interior reads mostly resolve through the insert-window
    # rescue anchored on their mate, so the default budget stays small
    # and the ladder keeps the wider budgets for -m more/ultra
    _DEEP_BLOCKS_BY_SENS = {"less": (1, 32), "default": (1, 64),
                            "more": (4, 128), "ultra": (16, 128)}
    # rarest-K window selection for the deep tier (None = all windows):
    # explore only the K least-populated seed buckets per read at cap
    # C//K
    _DEEP_N_SEL_BY_SENS = {"less": 4, "default": 4, "more": 6,
                           "ultra": None}

    @property
    def _DEEP_N_SEL(self):
        return self._DEEP_N_SEL_BY_SENS.get(self.al.sens, 4)

    @property
    def _DEEP_BLOCKS(self):
        return self._DEEP_BLOCKS_BY_SENS.get(self.al.sens, (4, 128))

    def _deep_escalate(self, out, ovf, max_tot, pre=None):
        """Resolve PAIR_OVERFLOW rows with the deep capped pass, one
        device call per E-quantum chunk. Pairs are grouped by WHICH mate
        overflowed (row cols 10/11): single-overflow pairs pay one deep
        mate plus a tier-1 rescore of the clean mate.

        With rescue (pemode 1/3) dual-overflow pairs are STAGED: deep mate
        1 only (stage 1, `pre`: the calls _deep_submit_stage1 submitted);
        a unique anchor then resolves the partner through the
        insert-window rescue, and only rows whose mate-1 deep was
        non-unique pay the two-mate deep. Returns {row: PePair} for
        rescue-resolved rows."""
        resolved: dict[int, PePair] = {}
        kw = self._deep_kw()

        def wave(groups):
            self._deep_collect(out, self._deep_submit(out, groups, kw))

        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        if self.pe_mode not in (1, 3):
            # no-rescue modes cannot stage through the window scan: dual
            # rows need both mates' stats in one cross-product call, at
            # the wider budget (all windows)
            NBb, NCbb = {"less": (2, 128), "more": (16, 128),
                         "ultra": (64, 128)}.get(self.al.sens, (4, 128))
            kw.update(n_blocks=NBb, block_size=NCbb, n_sel=None)
            groups = ((ovf[o1 & ~o2], True, False),
                      (ovf[~o1 & o2], False, True),
                      (ovf[o1 & o2], True, True))
            self._count("deep1", sum(len(r) for r, _, _ in groups))
            wave(groups)
            left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(left):
                self._count("deep3", len(left))
                wave(((left, True, True),))
            return resolved
        self._deep_collect(out, pre)

        def rescue_left():
            left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(left):
                # rows whose deep mate came back unique resolve via the
                # exhaustive insert-window scan; no dead-marking: a capped
                # deep's -1 is not proof of absence
                resolved.update(self._rescue_overflow(
                    out, left, max_tot, dead_mark=False,
                    stage="rescue_after_deep"))

        return self._deep_finish(out, ovf, wave, resolved, rescue_left)

    def _deep_kw(self):
        ctx = self._pctx
        al = self.al
        NB, NCb = self._DEEP_BLOCKS
        return dict(genome_len=len(al.index.genome.seq),
                    offsets=ctx["offsets"], lut_k=al.index.lut_k,
                    read_len=ctx["L"], n_blocks=NB, block_size=NCb,
                    max_ml=al.max_ml, max_tot=ctx["max_tot"],
                    mm_delta=al.mm_delta, min_ins=self.min_len,
                    max_ins=self.max_len, n_compact=al.n_compact,
                    n_extend=al.n_extend, n_sel=self._DEEP_N_SEL)

    def _deep_submit(self, out, groups, kw):
        """Submit deep_pe_pass_planes calls for every E-quantum chunk of
        every (rows, deep1, deep2) group; returns [(chunk, rows), ...]
        without collecting."""
        ctx = self._pctx
        P1, P2 = ctx["planes"]
        devs = []
        step = self._DEEP_QUANTA[-1]
        for rows, d1, d2 in groups:
            if len(rows) == 0:
                continue
            for s in range(0, len(rows), step):
                chunk = rows[s:s + step]
                E = next(q for q in self._DEEP_QUANTA if q >= len(chunk))
                idxs = np.full(E, chunk[0], np.int32)
                idxs[:len(chunk)] = chunk
                devs.append((chunk, deep_pe_pass_planes(
                    ctx["gview"], ctx["sa"], ctx["lut2"],
                    ctx["starts_d"], P1, P2,
                    _upload(idxs, ctx["gview"].device),
                    deep1=d1, deep2=d2, **kw)))
        return devs

    def _deep_collect(self, out, devs):
        for chunk, dev in devs:
            out[chunk] = unpack_rows12(dev.cpu().numpy())[:len(chunk)]

    def _deep_submit_stage1(self, out, ovf):
        """Submit stage-1 deep calls (no collection) for rows known to need
        deep work; the caller runs the rescue scans while these compute,
        then passes them back via _deep_escalate(pre=...)."""
        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        self._count("deep1", len(ovf))
        return self._deep_submit(out, ((ovf[o1 & ~o2], True, False),
                                       (ovf[~o1 & o2], False, True),
                                       (ovf[o1 & o2], True, False)),
                                 self._deep_kw())

    def _deep_finish(self, out, ovf, wave, resolved, rescue_left):
        rescue_left()
        # stage 2b: rows whose mate-1 deep found NOTHING in budget (code
        # -1): deep mate 2 instead, then rescue mate 1 from its anchor;
        # rows that still fail are unpairable: PAIR_NONE
        left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        d2 = left[(out[left, 10] == 0) & (out[left, 6] == -1)]
        if len(d2):
            self._count("deep2b", len(d2))
            wave(((d2, False, True),))
            rescue_left()
            dead = d2[out[d2, 5] == PAIR_OVERFLOW]
            out[dead, 5] = PAIR_NONE
        # stage 3: both mates deep — deep never overflows
        left = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        if len(left):
            self._count("deep3", len(left))
            wave(((left, True, True),))
        return resolved

    def _resolve_rows(self, out, n, i0, handles, recs1, recs2, max_tot):
        # the group-resident word planes, built once: every deep call and
        # rescue scan gathers probe words from them by group row
        L = self._pctx["L"]
        c1 = [words_from_2bit(h[0], h[1], L) for h in handles]
        c2 = [words_from_2bit(h[2], h[3], L) for h in handles]

        def cat(cs):
            return tuple(torch.cat([c[k] for c in cs], dim=1)
                         if len(cs) > 1 else cs[0][k] for k in range(4))
        self._pctx["planes"] = (cat(c1), cat(c2))
        ovf = np.nonzero(out[:n, 5] == PAIR_OVERFLOW)[0]
        self._count("overflow", len(ovf))
        pre_rescued: dict[int, PePair] = {}
        if len(ovf) and self.pe_mode in (1, 3):
            # RESCUE BEFORE DEEP (the reference's own flow): a mate whose
            # core buckets overflow is, under MaxIter semantics, "too
            # many matches" (SfxArray.cpp:6592), rescued from the uniquely
            # aligned anchor (AlignPartnerRead, KAligner.cpp:3333); the
            # residue's stage-1 deep calls are submitted before the
            # rescue scans are collected
            o1 = out[ovf, 10] != 0
            o2 = out[ovf, 11] != 0
            c1 = out[ovf, 6]
            c2 = out[ovf, 7]
            if self.pe_mode in (1, 2):
                dead = ovf[(o1 & ~o2 & (c2 == -1))
                           | (o2 & ~o1 & (c1 == -1))]
                out[dead, 5] = PAIR_NONE
                self._count("dead", len(dead))
            resc = (o2 & ~o1 & (c1 >= 0)) | (o1 & ~o2 & (c2 >= 0))
            deep_rows = ovf[~resc & (out[ovf, 5] == PAIR_OVERFLOW)]
            pre = self._deep_submit_stage1(out, deep_rows) \
                if len(deep_rows) else None
            pre_rescued = self._rescue_overflow(
                out, ovf[resc], max_tot, dead_mark=False,
                stage="rescue_before_deep")
            if pre is not None:
                pre_rescued.update(self._deep_escalate(
                    out, deep_rows, max_tot, pre=pre))
            ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        elif len(ovf):
            pre_rescued = self._rescue_overflow(out, ovf, max_tot,
                                                stage="rescue_before_deep")
            ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
            if len(ovf):
                pre_rescued.update(self._deep_escalate(out, ovf, max_tot))
                ovf = ovf[out[ovf, 5] == PAIR_OVERFLOW]
        if len(ovf):
            raise RuntimeError(
                f"{len(ovf)} pair rows still PAIR_OVERFLOW after the deep "
                f"tier, which is total (rows {ovf[:5].tolist()})")
        rescues = self._batch_rescue(out, n, max_tot) \
            if self.pe_mode in (1, 3) else {}
        rows_l = out[:n].tolist()   # one bulk convert: the per-row loop
        #                             then touches only Python ints
        for i in range(n):
            yield recs1[i0 + i], recs2[i0 + i], self._pair_from_row(
                rows_l[i], rescue=pre_rescued.get(i) or rescues.get(i))

    def _batch_rescue(self, out, n, max_tot) -> dict:
        """Orphan rescue: one window scan over every PAIR_NONE row with
        exactly one uniquely aligned mate (AlignPartnerRead,
        KAligner.cpp:3333)."""
        c1 = out[:n, 6].astype(np.int64)
        c2 = out[:n, 7].astype(np.int64)
        is_none = out[:n, 5] == PAIR_NONE
        m2 = is_none & (c1 >= 0) & (c2 == -1)   # anchor 1, rescue mate 2
        m1 = is_none & (c2 >= 0) & (c1 == -1)   # anchor 2, rescue mate 1
        ridx = np.concatenate([np.nonzero(m2)[0], np.nonzero(m1)[0]])
        if len(ridx) == 0:
            return {}
        self._count("orphan_rescue", len(ridx))
        anchor_who = np.concatenate(
            [np.ones(int(m2.sum()), np.int64),
             np.full(int(m1.sum()), 2, np.int64)])
        return self._window_rescue(out, ridx, anchor_who, max_tot)

    def _rescue_overflow(self, out, ovf, max_tot, dead_mark: bool = True,
                         stage: str = "rescue_before_deep") -> dict:
        """Rescue for PAIR_OVERFLOW rows (pemode 1/3): a pair where exactly
        ONE mate overflowed while the other aligned uniquely is resolved
        by the exhaustive insert-window scan anchored on the clean mate
        (KAligner.cpp:3333; MaxIter skip SfxArray.cpp:6592). Resolved rows
        leave PAIR_OVERFLOW; the deep tier sees only the residue.

        With dead_mark (valid only when the clean side carries complete
        tier stats), pemode 1/2 rows whose clean mate found nothing (code
        -1) can never pair: PAIR_NONE without deep work."""
        o1 = out[ovf, 10] != 0
        o2 = out[ovf, 11] != 0
        c1 = out[ovf, 6].astype(np.int64)
        c2 = out[ovf, 7].astype(np.int64)
        if dead_mark and self.pe_mode in (1, 2):
            dead = ovf[(o1 & ~o2 & (c2 == -1)) | (o2 & ~o1 & (c1 == -1))]
            out[dead, 5] = PAIR_NONE
            self._count("dead", len(dead))
        if self.pe_mode not in (1, 3):
            return {}
        r_m2 = ovf[o2 & ~o1 & (c1 >= 0)]   # anchor mate1, rescue mate 2
        r_m1 = ovf[o1 & ~o2 & (c2 >= 0)]   # anchor mate2, rescue mate 1
        ridx = np.concatenate([r_m2, r_m1])
        if len(ridx) == 0:
            return {}
        self._count(stage, len(ridx))
        anchor_who = np.concatenate(
            [np.ones(len(r_m2), np.int64), np.full(len(r_m1), 2,
                                                   np.int64)])
        res = self._window_rescue(out, ridx, anchor_who, max_tot)
        resolved = {}
        for i, pp in res.items():
            # either way the row leaves PAIR_OVERFLOW; the overflowed
            # mate's side code becomes -2 so the orphan rescue does not
            # scan the same window again
            out[i, 5] = PAIR_NONE
            out[i, 7 if int(out[i, 10]) == 0 else 6] = -2
            if pp is not None:
                resolved[i] = pp
        return resolved

    def _window_rescue(self, out, ridx, anchor_who, max_tot) -> dict:
        """Batched insert-window scans: for each row i in ridx, rescue the
        orphan mate (mate 2 when anchor_who == 1 else mate 1) around the
        anchor mate's unique locus (row col 6/7), the probe gathered on
        the device from the group's planes. Returns {row: PePair | None}
        covering every selected row."""
        c1 = out[:, 6].astype(np.int64)
        c2 = out[:, 7].astype(np.int64)
        code = np.where(anchor_who == 1, c1[ridx], c2[ridx])
        apos = code >> 1
        astrand = code & 1
        ctx = self._pctx
        g = self.al.index.genome
        L = ctx["L"]            # both mates: one length on this path
        gview = ctx["gview"]
        dev = gview.device
        scan_len = self.max_len - self.min_len + 1
        want_strand = np.where(astrand == 0, 1, 0)
        lo_all = np.where(astrand == 0, apos + self.min_len - L,
                          apos + L - self.max_len).astype(np.int32)
        out_map: dict[int, PePair | None] = {}
        P1, P2 = ctx["planes"]
        orphan_who = np.where(anchor_who == 1, 2, 1)
        RBW = 16384
        QW = (512, 1024, 2048, 4096, RBW)
        devs = []
        for s in range(0, len(ridx), RBW):
            tsel = np.arange(s, min(s + RBW, len(ridx)))
            q = next(x for x in QW if x >= len(tsel))
            li = np.zeros(q, np.int32)
            li[:len(tsel)] = ridx[tsel]
            wh = np.full(q, 1, np.int32)
            wh[:len(tsel)] = orphan_who[tsel]
            ws_ = np.zeros(q, np.int32)
            ws_[:len(tsel)] = want_strand[tsel]
            st_ = np.zeros(q, np.int32)
            st_[:len(tsel)] = lo_all[tsel]
            devs.append((tsel, seed_extend_fast.window_scan_pe(
                gview, P1, P2, *(_upload(a, dev) for a in (li, wh, ws_,
                                                           st_)),
                genome_len=len(g.seq), scan_len=scan_len, read_len=L)))
        starts_g = g.starts
        for tsel, dev_out in devs:
            best, bpos, n_best = (x.cpu().numpy()[:len(tsel)]
                                  for x in dev_out)
            # vectorised acceptance: unique in-window best within budget
            # + the orientation / insert / same-chromosome checks
            ap = apos[tsel]
            ast = astrand[tsel]
            opos = bpos.astype(np.int64)
            fwd_anchor = ast == 0
            left_p = np.where(fwd_anchor, ap, opos)
            right_end = np.where(fwd_anchor, opos + L, ap + L)
            ins = right_end - left_p
            order_ok = np.where(fwd_anchor, opos >= ap, ap >= opos)
            ci_a = np.searchsorted(starts_g, ap, side="right")
            ci_o = np.searchsorted(starts_g, opos, side="right")
            t_ok = ((best <= max_tot) & (n_best == 1) & order_ok
                    & (ci_a == ci_o) & (ins >= self.min_len)
                    & (ins <= self.max_len))
            for i in ridx[tsel[~t_ok]].tolist():
                out_map[i] = None
            amm = np.where(anchor_who[tsel] == 1,
                           out[ridx[tsel], 8], out[ridx[tsel], 9])
            ok_j = np.nonzero(t_ok)[0]
            cols = np.stack([ridx[tsel[ok_j]], anchor_who[tsel[ok_j]],
                             want_strand[tsel[ok_j]], bpos[ok_j],
                             best[ok_j], astrand[tsel[ok_j]],
                             apos[tsel[ok_j]], amm[ok_j],
                             ins[ok_j]]).T.tolist()
            for (i, who_a, wstr, op, bm, astr, apv, am, insv) in cols:
                o_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=wstr,
                                       pos=op, mm=bm, n_low=1)
                a_res = _k.AlignResult(_k.NAR_ACCEPTED, strand=astr,
                                       pos=apv, mm=am, n_low=1)
                if who_a == 1:
                    r1, r2, who = a_res, o_res, 2
                else:
                    r1, r2, who = o_res, a_res, 1
                out_map[i] = PePair(NAR_PE_ACCEPTED, r1, r2, tlen=insv,
                                    rescued=who)
        return out_map

    def _pair_from_row(self, row, rescue: "PePair | None" = None) -> PePair:
        (bid1, bid2, mm1, mm2, tlen, pcode, code1, code2,
         low1, low2) = (int(x) for x in row[:10])
        if pcode == PAIR_ACCEPT:
            return PePair(
                NAR_PE_ACCEPTED,
                _k.AlignResult(_k.NAR_ACCEPTED, strand=bid1 & 1,
                               pos=bid1 >> 1, mm=mm1, n_low=1),
                _k.AlignResult(_k.NAR_ACCEPTED, strand=bid2 & 1,
                               pos=bid2 >> 1, mm=mm2, n_low=1),
                tlen=tlen)
        if pcode == PAIR_NONE and self.pe_mode in (1, 3):
            # the orphan / overflow rescue's outcome
            if rescue is not None:
                return rescue
        if self.pe_mode in (3, 4):
            r1 = (_k.AlignResult(_k.NAR_ACCEPTED, strand=code1 & 1,
                                 pos=code1 >> 1, mm=low1, n_low=1)
                  if code1 >= 0 else None)
            r2 = (_k.AlignResult(_k.NAR_ACCEPTED, strand=code2 & 1,
                                 pos=code2 >> 1, mm=low2, n_low=1)
                  if code2 >= 0 else None)
            if r1 or r2:
                return PePair(NAR_PE_NOPAIR, r1, r2)
        return PePair(NAR_PE_NOPAIR)

    def write_sam_fast(self, path, pairs, cmdline: str = "",
                       emit_unmapped: bool = True, snp_caller=None,
                       chunk: int = 16384) -> dict:
        """PE SAM writer: buffers the (rec1, rec2, PePair) stream in chunks
        of one read length, converts sequences and qualities as whole
        arrays and emits the records through the native bulk formatter
        `format_sam_pe`; a pair of unequal mates is formatted on its own
        by `_pair_records_text`. Byte-identical to the JAX package's
        write_sam_fast. Raises native.NativeUnavailable without the host
        library."""
        lib = native.load()
        g = self.al.index.genome
        starts = g.starts.astype(np.int64)
        chrom_cat = "".join(g.names).encode()
        chrom_ofs = np.zeros(len(g.names) + 1, np.int64)
        chrom_ofs[1:] = np.cumsum([len(n) for n in g.names])
        stats = {"pairs": 0, NAR_PE_ACCEPTED: 0, NAR_PE_NOPAIR: 0,
                 "rescued": 0}
        _FWD = np.frombuffer(b"ACGTNNNN", np.uint8)
        _RC = np.frombuffer(b"TGCANNNN", np.uint8)

        def flush(buf, raw_f):
            n2 = 2 * len(buf)
            L = len(buf[0][0].codes)
            names = []
            flag = np.zeros(n2, np.int32)
            ci = np.full(n2, -1, np.int32)
            pos1 = np.zeros(n2, np.int64)
            rnext = np.full(n2, -2, np.int32)
            pnext = np.zeros(n2, np.int64)
            tlen = np.zeros(n2, np.int64)
            nm = np.full(n2, -1, np.int32)
            codes = np.zeros((n2, L), np.uint8)
            quals = np.zeros((n2, L), np.uint8)
            rev = np.zeros(n2, bool)
            keep = np.ones(n2, bool)
            snp_rows = []
            for j, (rec1, rec2, pp) in enumerate(buf):
                accepted = pp.nar == NAR_PE_ACCEPTED
                for which, (rec, res, mres) in enumerate(
                        ((rec1, pp.r1, pp.r2), (rec2, pp.r2, pp.r1))):
                    i = 2 * j + which
                    names.append(rec.name.encode())
                    f = FLAG_PAIRED | (FLAG_FIRST if which == 0
                                       else FLAG_SECOND)
                    me_ok = res is not None and res.nar == _k.NAR_ACCEPTED
                    mate_ok = (mres is not None
                               and mres.nar == _k.NAR_ACCEPTED)
                    codes[i, :len(rec.codes)] = rec.codes
                    if rec.qual is not None and len(rec.qual) == L:
                        quals[i] = np.asarray(rec.qual, np.uint8) + 33
                    if not me_ok:
                        if not emit_unmapped:
                            keep[i] = False
                        f |= FLAG_UNMAPPED
                        if not mate_ok:
                            f |= FLAG_MATE_UNMAPPED
                        flag[i] = f
                        continue
                    if accepted:
                        f |= FLAG_PROPER_PAIR
                    if res.strand == 1:
                        f |= FLAG_REVERSE
                        rev[i] = True
                    c = int(np.searchsorted(starts, res.pos,
                                            side="right") - 1)
                    ci[i] = c
                    pos1[i] = res.pos - starts[c] + 1
                    nm[i] = res.mm
                    if mate_ok:
                        if mres.strand == 1:
                            f |= FLAG_MATE_REVERSE
                        mc = int(np.searchsorted(starts, mres.pos,
                                                 side="right") - 1)
                        rnext[i] = -1 if mc == c else mc
                        pnext[i] = mres.pos - starts[mc] + 1
                        tlen[i] = pp.tlen if res.pos <= mres.pos \
                            else -pp.tlen
                    else:
                        f |= FLAG_MATE_UNMAPPED
                    flag[i] = f
                    if snp_caller is not None:
                        snp_rows.append((res.pos, i))
            # strand-oriented ascii sequences + reversed quals, vectorised
            seq_ascii = _FWD[codes]
            if rev.any():
                seq_ascii[rev] = _RC[codes[rev][:, ::-1]]
                qr = quals[rev]
                nzq = qr[:, 0] != 0
                qr[nzq] = qr[nzq][:, ::-1]
                quals[rev] = qr
            sel = np.nonzero(keep)[0]
            sel_names = [names[i] for i in sel]
            qn_cat = b"".join(sel_names)
            qn_ofs = np.zeros(len(sel) + 1, np.int64)
            qn_ofs[1:] = np.cumsum([len(x) for x in sel_names])
            max_cn = max((len(n) for n in g.names), default=1)
            cap = (int(qn_ofs[-1])
                   + len(sel) * (2 * L + 2 * max_cn + 160) + 16)
            out = ctypes.create_string_buffer(cap)
            # keep every array referenced until the native call returns
            a_flag = np.ascontiguousarray(flag[sel])
            a_ci = np.ascontiguousarray(ci[sel])
            a_pos = np.ascontiguousarray(pos1[sel])
            a_mapq = np.full(len(sel), 254, np.int32)
            a_rnext = np.ascontiguousarray(rnext[sel])
            a_pnext = np.ascontiguousarray(pnext[sel])
            a_tlen = np.ascontiguousarray(tlen[sel])
            a_nm = np.ascontiguousarray(nm[sel])
            a_seq = np.ascontiguousarray(seq_ascii[sel])
            a_qual = np.ascontiguousarray(quals[sel])
            P32 = ctypes.POINTER(ctypes.c_int32)
            P64 = ctypes.POINTER(ctypes.c_int64)
            PU8 = ctypes.POINTER(ctypes.c_uint8)
            nb = lib.format_sam_pe(
                qn_cat, qn_ofs.ctypes.data_as(P64),
                chrom_cat, chrom_ofs.ctypes.data_as(P64),
                a_flag.ctypes.data_as(P32), a_ci.ctypes.data_as(P32),
                a_pos.ctypes.data_as(P64), a_mapq.ctypes.data_as(P32),
                a_rnext.ctypes.data_as(P32), a_pnext.ctypes.data_as(P64),
                a_tlen.ctypes.data_as(P64), a_nm.ctypes.data_as(P32),
                a_seq.ctypes.data_as(PU8), a_qual.ctypes.data_as(PU8),
                len(sel), L, out, cap)
            if nb < 0:
                raise RuntimeError("format_sam_pe buffer overflow")
            raw_f.write(out.raw[:nb])
            if snp_caller is not None and snp_rows:
                spos = np.asarray([p for p, _ in snp_rows], np.int64)
                sidx = np.asarray([i for _, i in snp_rows])
                orient = codes[sidx].copy()
                r2 = rev[sidx]
                if r2.any():
                    rc = orient[r2][:, ::-1]
                    orient[r2] = np.where(rc < 4, 3 - rc, rc)
                snp_caller.add_alignments(spos, orient)

        with open(path, "w", newline="") as f:
            f.write("@HD\tVN:1.4\tSO:unsorted\n")
            for name, ln in zip(g.names, g.lengths):
                f.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
            f.write(f"@PG\tID:kit4b_tpu\tPN:kit4b_tpu\tCL:{cmdline}\n")
        with open(path, "ab") as raw_f:
            buf = []
            L0 = None
            for rec1, rec2, pp in pairs:
                stats["pairs"] += 1
                acc = pp.nar == NAR_PE_ACCEPTED
                stats[NAR_PE_ACCEPTED if acc else NAR_PE_NOPAIR] += 1
                if pp.rescued:
                    stats["rescued"] += 1
                if len(rec1.codes) != len(rec2.codes):
                    # rare unequal-mate pair: keep record order, format
                    # this one through the per-record path
                    if buf:
                        flush(buf, raw_f)
                        buf = []
                    raw_f.write(self._pair_records_text(
                        rec1, rec2, pp, emit_unmapped,
                        snp_caller).encode())
                    continue
                L = len(rec1.codes)
                if L0 is None:
                    L0 = L
                if L != L0:      # length change: flush the uniform run
                    if buf:
                        flush(buf, raw_f)
                    buf = []
                    L0 = L
                buf.append((rec1, rec2, pp))
                if len(buf) >= chunk:
                    flush(buf, raw_f)
                    buf = []
            if buf:
                flush(buf, raw_f)
        return stats

    def _pair_records_text(self, rec1, rec2, pp, emit_unmapped,
                           snp_caller) -> str:
        """Two SAM record lines for one pair, formatted record by record
        (write_sam_fast's path for a pair of unequal mates)."""
        g = self.al.index.genome
        starts_list = g.starts.tolist()
        accepted = pp.nar == NAR_PE_ACCEPTED
        lines = []
        for which, (rec, res, mate_res) in enumerate(
                ((rec1, pp.r1, pp.r2), (rec2, pp.r2, pp.r1))):
            flag = FLAG_PAIRED | (FLAG_FIRST if which == 0
                                  else FLAG_SECOND)
            me_ok = res is not None and res.nar == _k.NAR_ACCEPTED
            mate_ok = (mate_res is not None
                       and mate_res.nar == _k.NAR_ACCEPTED)
            if not me_ok:
                if not emit_unmapped:
                    continue
                flag |= FLAG_UNMAPPED
                if not mate_ok:
                    flag |= FLAG_MATE_UNMAPPED
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, False)
                lines.append(f"{rec.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t"
                             f"{seq}\t{qual}\n")
                continue
            if accepted:
                flag |= FLAG_PROPER_PAIR
            rev = res.strand == 1
            if rev:
                flag |= FLAG_REVERSE
            ci = bisect.bisect_right(starts_list, res.pos) - 1
            off = res.pos - starts_list[ci]
            rnext, pnext, tlen = "*", 0, 0
            if mate_ok:
                if mate_res.strand == 1:
                    flag |= FLAG_MATE_REVERSE
                mci = bisect.bisect_right(starts_list, mate_res.pos) - 1
                moff = mate_res.pos - starts_list[mci]
                rnext = "=" if mci == ci else g.names[mci]
                pnext = moff + 1
                tlen = pp.tlen if res.pos <= mate_res.pos else -pp.tlen
            else:
                flag |= FLAG_MATE_UNMAPPED
            seq, qual = seq_qual_for_strand(rec.codes, rec.qual, rev)
            lines.append(
                f"{rec.name}\t{flag}\t{g.names[ci]}\t{off + 1}\t254\t"
                f"{len(rec.codes)}M\t{rnext}\t{pnext}\t{tlen}\t{seq}\t"
                f"{qual}\tNM:i:{res.mm}\n")
            if snp_caller is not None:
                oriented = (dna.revcomp(rec.codes) if rev else rec.codes)
                snp_caller.add_alignments(
                    np.asarray([res.pos], np.int64), oriented[None, :])
        return "".join(lines)
