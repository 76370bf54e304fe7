"""kalign: seed-and-extend short-read aligner, single-end, on PyTorch.

Port of kit4b_tpu/align/kalign.py. A read batch is packed 2 bits a base on
the host (native `pack2bit_u8`), uploaded, and aligned on the device by
one tier-1 pass:

  - the compact path (no rescue asked for): `seed_extend_v5.
    fast_pass_packed_v5` when the index's bucket histogram predicts few
    escalations, else `seed_extend_v4.fast_pass_packed_v4`; one [B, 2]
    int32 row per read with the in-graph tier 2 applied. SAM text comes
    from the native `format_sam_se` (`write_sam_fast`);
  - the full-stats path (`micro_indel`, `splice_max` or `chimeric_pct`
    set, or `align_batch(return_raw=True)`): `seed_extend_v3.fast_pass_v3`,
    which returns each read's best loci (`hit_id`, `hit_mm`). Reads the
    substitutions-only classification leaves NOHIT go through the
    microInDel, splice and chimeric rescues (host numpy, `ops.indel`,
    `ops.splice`, `ops.chimeric`), in that order, and SAM records with
    their CIGARs come from the per-record `write_sam`.

Reads still overflowing climb the host escalation ladder
`((512, 512), (64, 8192))` through `seed_extend_fast.fast_pass`, the last
tier capped per bucket.

The host helpers of the JAX module (`pack_reads_2bit`, the pass schedule)
are re-homed here because that module imports jax at module top; tests hold
them byte-identical to their originals. Every device tensor lives on the
aligner's explicit `device` (CUDA by default; `device.resolve` raises when
it is absent).

`_force_full` (set by `--mlmode` 2-5) keeps the full-stats path without a
rescue, for the multiloci hit lists. `filter_alignments` applies the
chromosome, priority-region and PCR-duplicate filters to the record
stream, and `write_sam` writes BAM (with a coordinate-sorted BAI or CSI on
request, `io.bam`) for a path ending in .bam.

Not ported: genomes with 2*G+1 >= 2^31 or 2^31 clean suffixes, whose int32
locus ids pos*2+strand wrap (ROADMAP queue A item 18: JAX's per-shard
offsets). Paired ends are `align.pe`.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
import os
import queue
import re
import threading
import warnings
from collections import defaultdict
from collections import deque
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from .. import dna, native
from ..device import resolve
from ..index.sfx_index import SfxIndex
from ..io.bam import BamWriter
from ..io.fasta import SeqRecord, read_seq_blocks, read_seqs
from ..io.sam import (FLAG_REVERSE, FLAG_UNMAPPED, SamAlignment, SamWriter,
                      seq_qual_for_strand)
from ..ops import seed_extend_fast, seed_extend_v3, seed_extend_v4, \
    seed_extend_v5
from ..ops.chimeric import find_chimeric
from ..ops.extend_packed import pack_genome
from ..ops.indel import find_indels
from ..ops.seed_extend_v3 import make_lut2_device, unpack_result2
from ..ops.splice import find_splices
from ..utils.runtime import span

INT32_MAX = seed_extend_fast.INT32_MAX

TIER2 = (512, 192, 96)      # v5's in-graph tier 2: (E, NC2, NS2)
TIER2_V4 = (128, 192, 96)   # v4's: fast_pass_packed_v4's default


def pack_reads_2bit(reads: np.ndarray):
    """[B, L] uint8 codes -> ([B, ceil(L/4)] packed, [n_cap, 2] sparse N
    list), by the native `pack2bit_u8`. The N list holds (read, base) rows
    padded with 2^30 sentinels, which the device scatter drops; n_cap is
    the batch's N count rounded up to a power of two >= 4096, so the list
    always fits (the JAX version with n_cap=None)."""
    lib = native.load()
    B, L = reads.shape
    n_n = int((reads >= 4).sum())
    n_cap = 4096
    while n_cap < n_n:
        n_cap <<= 1
    L4 = (L + 3) // 4
    reads_c = np.ascontiguousarray(reads, dtype=np.uint8)
    packed = np.empty((B, L4), dtype=np.uint8)
    nlist = np.empty((n_cap, 2), dtype=np.int32)
    lib.pack2bit_u8(
        reads_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, L,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nlist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_cap)
    return packed, nlist


# sensitivity modes (reference ePMdefault/ePMMoreSens/ePMUltraSens/ePMLessSens
# mapped to slides + min-core adjustment, KAligner.cpp:9377-9393)
SENS_MODES = {
    "default": (0, 8),
    "more": (-1, 8),
    "ultra": (-2, 9),
    "less": (2, 6),
}


def auto_min_core_len(genome_len: int, sens: str = "default") -> int:
    """floor(log4(G)) - 1, clamped (KAligner.cpp:9369-9374, cKAMinCoreLen)."""
    auto = 0
    g = genome_len
    while g:
        g >>= 2
        auto += 1
    auto -= 1
    adj, _ = SENS_MODES[sens]
    return max(4, auto) + adj


@dataclass(frozen=True)
class PassSpec:
    allow_mm: int
    core_len: int
    offsets: tuple  # core window start offsets within the read


def build_pass_schedule(read_len: int, max_subs_per100: int, mm_delta: int,
                        genome_len: int, sens: str = "default",
                        ) -> tuple[list[PassSpec], int]:
    """Pigeonhole pass schedule for one read length.

    Returns (passes, max_tot_mm). Mirrors AlignReads' progressive loop +
    final call (SfxArray.cpp:7866-7893) and AlignRead's CoreLen/CoreDelta
    derivation (KAligner.cpp:9662-9669).
    """
    L = read_len
    if max_subs_per100 == 0:
        max_tot_mm = 0
    else:
        max_tot_mm = max(1, int(0.5 + L * max_subs_per100 / 100.0))
    max_tot_mm = min(max_tot_mm, 63)

    min_core = auto_min_core_len(genome_len, sens)
    denom = max_tot_mm + (1 if mm_delta == 1 else 2)
    core_final = max(min_core, L // denom)
    _, slides_per100 = SENS_MODES[sens]
    max_slides = max(1, (slides_per100 * L + 99) // 100)
    core_delta = max(L // max_slides - 1, core_final)

    passes: list[PassSpec] = []
    for m in range(max_tot_mm + 1):
        cl = L // (m + mm_delta)
        if cl <= core_final:
            break
        offsets = tuple(o for o in range(0, L - cl + 1, cl))
        passes.append(PassSpec(m, cl, offsets))
    # final pass at KAligner core/delta
    offsets = []
    o = 0
    while o + core_final <= L and len(offsets) < max_slides:
        offsets.append(o)
        o += core_delta
    passes.append(PassSpec(max_tot_mm, core_final, tuple(offsets)))
    return passes, max_tot_mm


# the SAM writer's class counts, in the order of the nar codes 0-3:
# accepted, no hit, multialign, excess Ns
NAR_NAMES = ("accepted", "nohit", "multi", "ns")
NAR_ACCEPTED, NAR_NOHIT, NAR_MULTI, NAR_NS = NAR_NAMES


@dataclass
class AlignResult:
    """One read's placement (kit4b_tpu's AlignResult)."""
    nar: str
    strand: int = 0        # 0 = '+', 1 = '-'
    pos: int = -1          # concatenated-genome start
    mm: int = -1
    n_low: int = 0
    nxt_mm: int = INT32_MAX
    multi_ids: np.ndarray | None = None  # pos*2+strand of multiloci hits
    cigar: str | None = None             # set by the rescues and -x
    trim_left: int = 0                   # AutoTrimFlanks 5' soft clip
    trim_right: int = 0                  # AutoTrimFlanks 3' soft clip
    secondary: bool = False              # SAM 0x100 (mlmode 5 report-all)


class KAligner:
    """Batch seed-and-extend aligner over a loaded SfxIndex, on `device`.

    Reads whose candidate total exceeds the tier capacity are escalated
    through `escalation` (batch, capacity) tiers (the reference's MaxIter
    ladder, ngskit4b/KAligner.h:53-56); reads still overflowing the last
    tier are classified multi. `micro_indel` (-y), `splice_max` (-l) and
    `chimeric_pct` (-C) turn on the rescues of NOHIT reads, which read the
    full-stats tier 1's hit lists."""

    def __init__(self, index: SfxIndex, *,
                 max_subs: int = 5,          # per 100bp (-s)
                 mm_delta: int = 1,          # MinEditDist (-r)
                 max_ml: int = 5,            # cDfltMaxMultiHits
                 max_ns: int = 1,            # cDfltMaxNs (per 100bp, min 1)
                 n_compact: int = 24,        # tier-1 per-read candidate cap
                 n_extend: int = 12,         # tier-1 distinct-locus cap
                 batch_size: int = 16384,
                 sens: str = "default",
                 escalation: tuple = ((512, 512), (64, 8192)),
                 micro_indel: int = 0,   # microInDel max length (-y), 0=off
                 splice_max: int = 0,    # splice junction max gap (-l), 0=off
                 chimeric_pct: int = 0,  # min chimeric len % (-C), 0=off
                 use_v5: bool | None = None,  # None = auto by histogram
                 device: str | torch.device = "cuda"):
        self.index = index
        self.max_subs = max_subs
        self.mm_delta = mm_delta
        self.max_ml = max_ml
        self.max_ns = max_ns
        self.n_compact = n_compact
        self.n_extend = n_extend
        self.batch_size = batch_size
        self.sens = sens
        self.escalation = escalation
        self.micro_indel = micro_indel
        self.splice_max = splice_max
        self.chimeric_pct = chimeric_pct
        self.use_v5 = use_v5
        self.device = resolve(device)
        self._schedules: dict[int, tuple[list[PassSpec], int]] = {}
        self._fast_dev: dict[int, tuple] = {}   # nw2 -> (gview, sa, lut, lut2)
        self._lut4 = None       # device lut4 (read-length independent)
        self._lut4_decided: dict[int, bool] = {}
        self._host_packed = None

    def schedule_for(self, read_len: int):
        if read_len not in self._schedules:
            self._schedules[read_len] = build_pass_schedule(
                read_len, self.max_subs, self.mm_delta,
                len(self.index.genome.seq), self.sens)
        return self._schedules[read_len]

    def _device_for(self, read_len: int):
        """(gview, sa, lut, lut2) device tensors for this read length's
        word count."""
        nw2 = (read_len + 15) // 16 + 1
        if nw2 not in self._fast_dev:
            if (2 * len(self.index.genome.seq) + 1 >= 2 ** 31
                    or int(self.index.lut[-1]) >= 2 ** 31):
                raise NotImplementedError(
                    "genomes with 2*G+1 >= 2^31 or 2^31 clean suffixes: "
                    "the int32 locus id pos*2+strand wraps past 2^30 "
                    "bases, so they need the per-shard offsets of "
                    "ROADMAP.md queue A item 18")
            if self._host_packed is None:
                self._host_packed = pack_genome(self.index.genome.seq, 65)
            gpack, gbad = self._host_packed
            gview = seed_extend_fast.make_gview_device(gpack, gbad, nw2,
                                                       self.device)
            sa = torch.from_numpy(
                self.index.sa_clean.astype(np.int32)).to(self.device)
            lut = torch.from_numpy(
                self.index.lut.astype(np.int32)).to(self.device)
            self._fast_dev[nw2] = (gview, sa, lut, make_lut2_device(lut))
        return self._fast_dev[nw2]

    def _lut4_for(self, read_len: int, sa):
        """Device lut4 (flattened bucket table) when the v5 tier 1 is worth
        it: escalations predicted tiny by the host-side bucket histogram and
        at most 4^12 keys. None keeps the v4 tier 1. Decided per read length
        (window counts differ); the table is built once."""
        if read_len not in self._lut4_decided:
            decided = False
            if self.use_v5 is not False:
                if len(self.index.lut) - 1 > 4 ** 12:
                    if self.use_v5:
                        warnings.warn(
                            "use_v5=True ignored: lut has "
                            f"{len(self.index.lut) - 1} keys > 4^12; the "
                            "flattened lut4 would exceed the memory budget "
                            "— running the v4 tier-1 instead", RuntimeWarning)
                else:
                    _, mtm = self.schedule_for(read_len)
                    w = len(self._offsets_for(read_len, mtm))
                    est = seed_extend_v5.host_escalation_estimate(
                        self.index.lut, w)
                    decided = bool(self.use_v5) or est <= 0.004
            if decided and self._lut4 is None:
                _, _, lut, _ = self._device_for(read_len)
                self._lut4 = seed_extend_v5.make_lut4_device(lut, sa)
            self._lut4_decided[read_len] = decided
        return self._lut4 if self._lut4_decided[read_len] else None

    def _offsets_for(self, read_len: int, max_tot_mm: int) -> tuple:
        # discovery must reach max_tot + delta - 1 so next-best tracking
        # within MinEditDist is complete (SfxArray.cpp:7869-7878)
        return seed_extend_fast.fast_offsets(
            read_len, self.index.lut_k,
            max_tot_mm + max(self.mm_delta - 1, 0))

    _force_full = False   # set True when callers need multiloci hit lists

    def _use_compact(self) -> bool:
        """Compact device classification unless hit lists are needed on the
        host (the rescues, or --mlmode's multiloci candidates)."""
        return not (self.micro_indel or self.splice_max
                    or self.chimeric_pct or self._force_full)

    # --- device pass (submit / collect split for pipelining) ---------------
    def _submit(self, reads: np.ndarray, n_compact: int | None = None,
                compact: bool | None = None, capped: bool = False):
        """Starts a batch on the device. Tier 1 (n_compact None): compact,
        returning ("packed", [B, 2] rows), or full-stats (`fast_pass_v3`),
        returning its dict; compact None follows `_use_compact`. With
        n_compact, a full-stats escalation tier at that capacity
        (`fast_pass`). Nothing here waits for the device."""
        B, L = reads.shape
        _, max_tot_mm = self.schedule_for(L)
        gview, sa, lut, lut2 = self._device_for(L)
        offsets = self._offsets_for(L, max_tot_mm)
        nc = n_compact or self.n_compact
        # capped tiers clamp per-bucket SA exploration (reference MaxIter
        # analog, KAligner.h:53-56) so the pass is total: with
        # cap = nc // (2*W) the clamped candidate total never overflows
        cap = max(1, nc // (2 * len(offsets))) if capped else None
        kw = dict(genome_len=len(self.index.genome.seq), offsets=offsets,
                  lut_k=self.index.lut_k, n_compact=nc)
        if compact is None:
            compact = self._use_compact()
        if n_compact is not None:
            if compact:
                raise NotImplementedError(
                    "a compact pass at another capacity "
                    "(fast_pass_compact) serves only genomes whose int32 "
                    "locus ids wrap: ROADMAP.md queue A item 18")
            with span("kalign.upload"):
                return seed_extend_fast.fast_pass(
                    gview, sa, lut, torch.from_numpy(reads).to(self.device),
                    max_ml=self.max_ml, max_per_bucket=cap, **kw)
        reads2b, nlist = pack_reads_2bit(reads)
        with span("kalign.upload"):
            r2b = torch.from_numpy(reads2b).to(self.device)
            nl = torch.from_numpy(nlist).to(self.device)
            if not compact:
                return seed_extend_v3.fast_pass_v3(
                    gview, sa, lut2, r2b, nl, read_len=L, max_ml=self.max_ml,
                    n_extend=self.n_extend, max_per_bucket=cap, **kw)
            common = dict(read_len=L, max_tot_mm=max_tot_mm,
                          mm_delta=self.mm_delta, n_extend=self.n_extend,
                          **kw)
            lut4 = self._lut4_for(L, sa)
            if lut4 is not None:
                return ("packed", seed_extend_v5.fast_pass_packed_v5(
                    gview, sa, lut2, lut4, r2b, nl, tier2=TIER2, **common))
            return ("packed", seed_extend_v4.fast_pass_packed_v4(
                gview, sa, lut2, r2b, nl, max_per_bucket=cap,
                tier2=TIER2_V4, **common))

    def _escalate(self, reads: np.ndarray, todo: np.ndarray, merge,
                  n: int | None = None) -> None:
        """The host ladder: rows `todo` (bool [B]) rerun through the
        escalation tiers, each chunk padded to the tier's batch; merge(
        chunk, out) takes a tier's host dict for the read indices `chunk`
        and returns the rows still overflowing. With n, only the first n
        rows climb: the rest pad a batch, and each row's answer is its
        own, so leaving them out changes no real row."""
        if n is not None:
            todo[n:] = False
        with span("kalign.escalate"):
            for ti, (bt, nct) in enumerate(self.escalation):
                idxs = np.nonzero(todo)[0]
                if len(idxs) == 0:
                    break
                final = ti == len(self.escalation) - 1
                for s in range(0, len(idxs), bt):
                    chunk = idxs[s:s + bt]
                    sub = reads[chunk]
                    if len(chunk) < bt:
                        sub = np.concatenate([sub, np.repeat(
                            sub[:1], bt - len(chunk), axis=0)])
                    out = self._submit(sub, n_compact=nct, compact=False,
                                       capped=final)
                    todo[chunk] = merge(chunk, {
                        k: v.cpu().numpy()[:len(chunk)]
                        for k, v in out.items()})

    def _code_from_full(self, host: dict, max_tot_mm: int) -> np.ndarray:
        """Classify full-stats rows into compact codes (escalation merge)."""
        low = host["low_mm"].astype(np.int64)
        aligned = low <= max_tot_mm
        unique = (aligned & ~host["overflow"] & (host["n_low"] == 1)
                  & ((host["nxt_mm"].astype(np.int64) - low)
                     >= self.mm_delta))
        best = host["hit_id"][:, 0].astype(np.int64)
        return np.where(host["overflow"], -3,
                        np.where(unique, best,
                                 np.where(aligned, -2, -1))).astype(np.int64)

    def _ns_bad(self, reads: np.ndarray) -> np.ndarray:
        """Reads with more Ns than max_ns per 100 bases (at least max_ns)."""
        L = reads.shape[1]
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        return (reads == dna.BASE_N).sum(axis=1) > max_ns_seq

    def _collect_compact(self, devout, reads: np.ndarray,
                         n: int | None = None) -> dict:
        """Fetch [B, 2] compact rows (waits for the device); escalate -3
        rows (of the first n) through the host ladder; return the
        classification dict."""
        with span("kalign.result_wait"):
            rows = devout[1].cpu().numpy()
        code, low, n_low = unpack_result2(rows)
        _, max_tot_mm = self.schedule_for(reads.shape[1])

        def merge(chunk, out2):
            code[chunk] = self._code_from_full(out2, max_tot_mm)
            low[chunk] = out2["low_mm"]
            n_low[chunk] = out2["n_low"]
            return code[chunk] == -3
        self._escalate(reads, code == -3, merge, n)
        # final-tier overflow (-3) is classified multi, as the reference
        # classifies MaxIter-truncated reads
        nar = np.where(self._ns_bad(reads), 3,
                       np.where(code >= 0, 0,
                                np.where(code == -1, 1, 2))).astype(np.uint8)
        pos = np.where(code >= 0, code >> 1, -1)
        strand = np.where(code >= 0, code & 1, 0)
        return {"nar": nar, "pos": pos, "strand": strand, "mm": low,
                "low_mm": low, "n_low": n_low, "nxt_mm": None,
                "hit_id": None, "hit_mm": None,
                "overflow": code == -3, "max_tot_mm": max_tot_mm}

    def _collect(self, devout: dict, reads: np.ndarray,
                 n: int | None = None) -> dict:
        """Fetch full-stats tier-1 results (waits for the device); rerun
        overflowed reads (of the first n) through the host ladder.
        `overflow` is True after it only where the final tier overflowed."""
        host = {k: v.cpu().numpy().copy() for k, v in devout.items()}

        def merge(chunk, out2):
            for key in ("low_mm", "n_low", "nxt_mm", "hit_id", "hit_mm"):
                host[key][chunk] = out2[key]
            return out2["overflow"]
        trunc = host["overflow"].copy()
        self._escalate(reads, trunc, merge, n)
        host["overflow"] = trunc
        return host

    def _classify(self, reads: np.ndarray, host: dict) -> dict:
        """Full-stats host dict -> the classification dict, hit lists
        included."""
        _, max_tot_mm = self.schedule_for(reads.shape[1])
        low = host["low_mm"].astype(np.int64)
        n_low = host["n_low"].astype(np.int64)
        nxt = host["nxt_mm"].astype(np.int64)
        trunc = host["overflow"]
        aligned = low <= max_tot_mm
        unique = (aligned & ~trunc & (n_low == 1)
                  & ((nxt - low) >= self.mm_delta))
        nar = np.where(self._ns_bad(reads), 3,
                       np.where(unique, 0, np.where(aligned, 2, 1))
                       ).astype(np.uint8)
        hid = host["hit_id"][:, 0].astype(np.int64)
        return {"nar": nar, "pos": hid >> 1, "strand": (hid & 1),
                "mm": low, "low_mm": low, "n_low": n_low, "nxt_mm": nxt,
                "hit_id": host["hit_id"].astype(np.int64),
                "hit_mm": host["hit_mm"].astype(np.int64),
                "overflow": trunc, "max_tot_mm": max_tot_mm}

    def _collect_raw(self, devout, reads: np.ndarray,
                     n: int | None = None) -> dict:
        """The classification dict of either tier 1's device output; with
        n, rows past the first n are padding and skip the ladder."""
        if isinstance(devout, dict):
            return self._classify(reads, self._collect(devout, reads, n))
        return self._collect_compact(devout, reads, n)

    def align_batch_raw(self, reads: np.ndarray) -> dict:
        """Vectorized alignment of a [B, L] uint8 code batch: numpy arrays
        nar [B] uint8 (0=accepted 1=nohit 2=multi 3=excess-Ns),
        pos/strand/mm [B] (valid where accepted), low_mm, n_low, overflow,
        and the full-stats keys (None on the compact path)."""
        return self._collect_raw(self._submit(reads), reads)

    def align_batch(self, reads: np.ndarray, return_raw: bool = False):
        """Align a [B, L] uint8 code batch; returns one AlignResult per read
        (and, with return_raw, the raw per-read stat arrays, hit lists
        included, for pairing)."""
        compact = None if not return_raw else False
        return self._finalize(reads, self._submit(reads, compact=compact),
                              return_raw)

    def _finalize(self, reads, devout, return_raw: bool = False,
                  n: int | None = None):
        """Results of a submitted batch, the rescues applied. With n, the
        batch's rows past the first n are padding: they skip the ladder
        and the rescues, and no result is made for them."""
        raw = self._collect_raw(devout, reads, n)
        if n is not None:
            reads = reads[:n]
            raw = {k: v[:n] if isinstance(v, np.ndarray) else v
                   for k, v in raw.items()}
        results = self._to_results(raw)
        hit_id, hit_mm = raw["hit_id"], raw["hit_mm"]
        # JAX's order: indel, then splice, then chimeric, each on the reads
        # the ones before it left NOHIT
        if self.micro_indel:
            self._indel_rescue(reads, results, hit_id, hit_mm,
                               raw["max_tot_mm"])
        if self.splice_max:
            self._splice_rescue(reads, results, hit_id, hit_mm)
        if self.chimeric_pct:
            self._chimeric_rescue(reads, results, hit_id, hit_mm)
        if return_raw:
            return results, {"low_mm": raw["low_mm"], "n_low": raw["n_low"],
                             "nxt_mm": raw["nxt_mm"], "hit_id": hit_id,
                             "hit_mm": hit_mm, "overflow": raw["overflow"]}
        return results

    def _to_results(self, raw: dict) -> list:
        nar = raw["nar"]
        pos = raw["pos"]
        strand = raw["strand"]
        low = raw["low_mm"]
        n_low = raw["n_low"]
        nxt = raw["nxt_mm"]
        has_hits = raw["hit_id"] is not None
        at_low = (raw["hit_mm"] == low[:, None]) if has_hits else None
        results: list[AlignResult] = []
        for i in range(len(nar)):
            c = nar[i]
            if c == 0:
                results.append(AlignResult(
                    NAR_ACCEPTED, strand=int(strand[i]), pos=int(pos[i]),
                    mm=int(low[i]), n_low=1,
                    nxt_mm=int(nxt[i]) if nxt is not None else INT32_MAX))
            elif c == 2:
                results.append(AlignResult(
                    NAR_MULTI, mm=int(low[i]), n_low=int(n_low[i]),
                    nxt_mm=int(nxt[i]) if nxt is not None else INT32_MAX,
                    multi_ids=(raw["hit_id"][i][at_low[i]]
                               if has_hits else None)))
            else:
                results.append(AlignResult(NAR_NAMES[c]))
        return results

    def _rescue(self, finder, reads, results, hit_id, hit_mm, **kw):
        """One rescue over the reads still NOHIT that have a hit: each read
        oriented by its best hit's strand, its candidates the hits on that
        strand; a read the finder places becomes accepted with the finder's
        CIGAR."""
        todo = [i for i, r in enumerate(results)
                if r.nar == NAR_NOHIT and hit_mm[i][0] < INT32_MAX]
        if not todo:
            return
        C = hit_id.shape[1]
        L = reads.shape[1]
        B = len(todo)
        oriented = np.zeros((B, L), np.uint8)
        pos = np.full((B, C), INT32_MAX, np.int64)
        strand = np.zeros((B, C), np.int64)
        for j, i in enumerate(todo):
            top_strand = int(hit_id[i][0]) & 1
            r = reads[i]
            oriented[j] = dna.revcomp(r) if top_strand else r
            for c in range(C):
                hid = int(hit_id[i][c])
                if hid == INT32_MAX or (hid & 1) != top_strand:
                    continue
                pos[j, c] = hid >> 1
                strand[j, c] = top_strand
        hits = finder(self.index.genome.seq, oriented, pos, strand, **kw)
        for j, i in enumerate(todo):
            h = hits[j]
            if h is None:
                continue
            results[i] = AlignResult(
                NAR_ACCEPTED, strand=h.strand, pos=h.pos, mm=h.mm,
                n_low=1, cigar=h.cigar(L))

    def _indel_rescue(self, reads, results, hit_id, hit_mm, max_tot_mm):
        """Second-chance microInDel pass (LocateInDels equivalent): the
        over-budget candidate loci anchor a single-indel split search
        (ops/indel.py)."""
        self._rescue(find_indels, reads, results, hit_id, hit_mm,
                     max_indel=self.micro_indel)

    def _splice_rescue(self, reads, results, hit_id, hit_mm):
        """Splice-junction pass (LocateSpliceJuncts equivalent): candidate
        locus pairs from the multiloci hits anchor a two-segment search."""
        self._rescue(find_splices, reads, results, hit_id, hit_mm,
                     max_gap=self.splice_max)

    def _chimeric_rescue(self, reads, results, hit_id, hit_mm):
        """Chimeric flank-trim pass (SfxArray.cpp:7925 adaptive trim)."""
        self._rescue(find_chimeric, reads, results, hit_id, hit_mm,
                     min_chimeric_pct=self.chimeric_pct,
                     subs_per_100=self.max_subs)

    def _pad_batch(self, recs: list[SeqRecord]) -> np.ndarray:
        arr = np.stack([r.codes for r in recs])
        n = len(recs)
        if n < self.batch_size:
            # pad to the fixed batch size so every device pass has the
            # same shapes
            pad = np.repeat(arr[:1], self.batch_size - n, axis=0)
            arr = np.concatenate([arr, pad])
        return arr

    def _batches(self, records: Iterable[SeqRecord]):
        """Record lists of one read length, at most batch_size each."""
        buckets: dict[int, list[SeqRecord]] = {}
        for rec in records:
            bl = buckets.setdefault(len(rec.codes), [])
            bl.append(rec)
            if len(bl) >= self.batch_size:
                yield bl
                buckets[len(rec.codes)] = []
        for bl in buckets.values():
            if bl:
                yield bl

    def _in_flight(self, batches, collect=None):
        """(meta, [B, L] batch, its real rows n) -> (meta, batch,
        collect(device output, batch, n)), with two device batches in
        flight: batch k+1 is submitted before batch k is collected.
        collect defaults to the classification dict (`_collect_raw`)."""
        collect = collect or self._collect_raw
        pending: deque = deque()
        for meta, arr, n in batches:
            pending.append((meta, arr, n, self._submit(arr)))
            if len(pending) >= 2:
                meta0, arr0, n0, dev0 = pending.popleft()
                yield meta0, arr0, collect(dev0, arr0, n0)
        while pending:
            meta0, arr0, n0, dev0 = pending.popleft()
            yield meta0, arr0, collect(dev0, arr0, n0)

    def align_records(self, records: Iterable[SeqRecord]):
        """(SeqRecord, AlignResult) stream, batching by read length, the
        rescues applied; two device batches in flight and record parsing
        on a background thread (the reference's reads-loader,
        KAligner.cpp:4786)."""
        def pipeline(source):
            for recs, _, results in self._in_flight(
                    ((bl, self._pad_batch(bl), len(bl)) for bl in source),
                    lambda dev, arr, n: self._finalize(arr, dev, n=n)):
                yield from zip(recs, results)

        yield from _prefetched(self._batches(records), pipeline)

    def align_records_raw(self, records: Iterable[SeqRecord]):
        """Batched streaming for the SAM writer, batching by read length:
        yields (recs, padded batch, classification dict) per batch, two
        device batches in flight and record parsing on a background
        thread."""
        def pipeline(source):
            return self._in_flight((bl, self._pad_batch(bl), len(bl))
                                   for bl in source)

        yield from _prefetched(self._batches(records), pipeline)


def _prefetched(source, consume):
    """Runs `source` on a background thread (two items ahead) and yields
    from consume(items); re-raises the producer's exception at the end."""
    q: queue.Queue = queue.Queue(maxsize=2)
    sentinel = object()
    err: list[BaseException] = []

    def producer():
        try:
            items = iter(source)
            while True:
                with span("kalign.parse"):
                    item = next(items, sentinel)
                if item is sentinel:
                    break
                q.put(item)
        except BaseException as e:   # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def items():
        while True:
            with span("kalign.parse_wait"):
                item = q.get()
            if item is sentinel:
                return
            yield item

    yield from consume(items())
    t.join()
    if err:
        raise err[0]


def filter_alignments(aligned, genome, *, chrom_include=None,
                      chrom_exclude=None, priority_bed=None,
                      max_pcr_dups: int = 0):
    """Post-acceptance filters applied to the (rec, res) stream, mirroring
    the reference phases FiltByChroms (KAligner.cpp:696),
    FiltByPriorityRegions (:707), and ReducePCRduplicates (:634).

    - chrom include/exclude regex lists (-Z/-z) demote accepted hits on
      excluded chromosomes to 'nohit'.
    - priority_bed: accepted hits must overlap a feature.
    - max_pcr_dups: at most this many accepted reads per (start, strand)
      locus; 0 disables. Requires a buffered pass (sorted by locus), so this
      generator materializes when enabled.
    """
    inc = [re.compile(x) for x in (chrom_include or [])]
    exc = [re.compile(x) for x in (chrom_exclude or [])]

    def chrom_ok(name: str) -> bool:
        if inc:
            return any(p_.search(name) for p_ in inc)
        if exc:
            return not any(p_.search(name) for p_ in exc)
        return True

    def apply(rec, res):
        if res.nar != NAR_ACCEPTED:
            return rec, res
        ci, off = genome.locate(np.array([res.pos]))
        name = genome.names[int(ci[0])]
        if not chrom_ok(name):
            return rec, AlignResult(NAR_NOHIT)
        if priority_bed is not None:
            L = len(rec.codes)
            if not priority_bed.overlapping(name, int(off[0]),
                                            int(off[0]) + L):
                return rec, AlignResult(NAR_NOHIT)
        return rec, res

    if not max_pcr_dups:
        for rec, res in aligned:
            yield apply(rec, res)
        return
    # PCR duplicate reduction needs locus grouping: buffer, count per
    # (pos, strand), demote beyond the cap (reference keeps the first)
    buffered = [apply(rec, res) for rec, res in aligned]
    counts: dict = {}
    for rec, res in buffered:
        if res.nar != NAR_ACCEPTED:
            yield rec, res
            continue
        key = (res.pos, res.strand)
        n = counts.get(key, 0) + 1
        counts[key] = n
        if n > max_pcr_dups:
            yield rec, AlignResult(NAR_NOHIT)
        else:
            yield rec, res


def write_align_stats(path, stats: dict, sub_hist: np.ndarray,
                      insert_hist: np.ndarray | None = None) -> None:
    """Aligner stats CSV (reference -O output: substitution distribution,
    KAligner.cpp:3600; PE insert-size distribution, :5323)."""
    with open(path, "w") as f:
        f.write('"section","key","value"\n')
        for k, v in stats.items():
            f.write(f'"classification","{k}",{v}\n')
        for i, c in enumerate(sub_hist):
            if c:
                f.write(f'"substitutions","{i}",{int(c)}\n')
        if insert_hist is not None:
            for i, c in enumerate(insert_hist):
                if c:
                    f.write(f'"insert_size","{i}",{int(c)}\n')


class _SortedBam:
    """BamWriter-compatible buffer: a BAI or CSI needs coordinate order, so
    the records are kept, sorted by (chromosome, position) and written on
    exit (the reference sorts accepted hits before WriteBAMReadHits,
    KAligner.cpp:5718). index True writes a BAI, "csi" a CSI."""

    def __init__(self, path, chrom_names, chrom_lengths, *, index, **kw):
        self._a = (path, chrom_names, chrom_lengths)
        self._kw = dict(kw, index=index)
        self._order = {n: i for i, n in enumerate(chrom_names)}
        self._recs: list[SamAlignment] = []

    def write(self, aln: SamAlignment) -> None:
        self._recs.append(aln)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._recs.sort(key=lambda r: (self._order.get(r.rname, 1 << 30),
                                       r.pos))
        with BamWriter(*self._a, **self._kw) as bw:
            for r in self._recs:
                bw.write(r)


def write_sam(path, index: SfxIndex, aligned, cmdline: str = "",
              emit_unmapped: bool = True, snp_caller=None,
              stats_path=None, bam_index=False) -> dict:
    """Write a (SeqRecord, AlignResult) stream to SAM, record by record,
    with the rescues' and the flank trim's CIGARs, or to BAM when the path
    ends .bam (coordinate-sorted with a BAI when `bam_index` is true, a CSI
    when it is "csi"); returns the class counts (every nar seen, phase and
    filter demotions included). Byte-identical to the JAX package's
    write_sam.

    NM counts the I/D bases of a CIGAR as well as the substitutions; MAPQ
    is the reference's (KAligner.cpp:6146-6233): 254, less 20 for a splice
    (N), less 10 for a microInDel (I/D), scaled by the matched share of
    the read. `snp_caller` (align.snp.SnpCaller) accumulates the plain
    accepted reads into its pileup (the kalign SNP phase input,
    KAligner.cpp:795-809); `stats_path` writes the substitution
    distribution CSV (-O)."""
    g = index.genome
    stats = defaultdict(int)
    stats.update(dict.fromkeys(NAR_NAMES, 0))
    snp_pos: list[int] = []
    snp_reads: list[np.ndarray] = []

    def flush_snp():
        if snp_caller is not None and snp_pos:
            snp_caller.add_alignments(np.asarray(snp_pos, np.int64),
                                      np.stack(snp_reads))
            snp_pos.clear()
            snp_reads.clear()

    sub_hist = np.zeros(64, np.int64)
    starts_list = g.starts.tolist()  # per-read locate via bisect
    writer = SamWriter
    if str(path).endswith(".bam"):
        writer = functools.partial(_SortedBam, index=bam_index) \
            if bam_index else BamWriter
    with writer(path, g.names, g.lengths, pg_cl=cmdline) as w:
        for rec, res in aligned:
            stats[res.nar] += 1
            if res.nar == NAR_ACCEPTED:
                ci = bisect.bisect_right(starts_list, res.pos) - 1
                off = res.pos - starts_list[ci]
                rev = res.strand == 1
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, rev)
                cigar = res.cigar or f"{len(rec.codes)}M"
                nm = res.mm
                matched = len(rec.codes)
                if res.cigar:
                    # NM counts indel bases (SAM spec); 'N' skips do not
                    nm += sum(int(x) for x in
                              re.findall(r"(\d+)[ID]", res.cigar))
                    matched = sum(int(x) for x in
                                  re.findall(r"(\d+)M", res.cigar))
                mapq = 254
                if res.cigar:
                    if "N" in res.cigar:
                        mapq -= 20
                    elif "I" in res.cigar or "D" in res.cigar:
                        mapq -= 10
                mapq = min(254, max(1, mapq * matched // len(rec.codes)))
                flag = FLAG_REVERSE if rev else 0
                if res.secondary:
                    flag |= 0x100
                w.write(SamAlignment(
                    qname=rec.name, flag=flag,
                    rname=g.names[ci], pos=off + 1,
                    mapq=mapq, cigar=cigar, seq=seq, qual=qual,
                    tags=(f"NM:i:{nm}",)))
                sub_hist[min(res.mm, 63)] += 1
                if res.cigar is not None or res.secondary:
                    continue  # indel/secondary reads do not feed the pileup
                if snp_caller is not None:
                    oriented = (dna.revcomp(rec.codes) if rev
                                else rec.codes)
                    snp_pos.append(res.pos)
                    snp_reads.append(oriented)
                    if len(snp_pos) >= 16384 and \
                            len(snp_reads[0]) == len(oriented):
                        flush_snp()
            elif emit_unmapped:
                seq, qual = seq_qual_for_strand(rec.codes, rec.qual, False)
                w.write(SamAlignment(
                    qname=rec.name, flag=FLAG_UNMAPPED, rname="*", pos=0,
                    mapq=0, cigar="*", seq=seq, qual=qual))
            # a length change would break np.stack batching; flush eagerly
            if snp_caller is not None and snp_reads and \
                    len(snp_reads[-1]) != len(snp_reads[0]):
                last_p, last_r = snp_pos.pop(), snp_reads.pop()
                flush_snp()
                snp_pos.append(last_p)
                snp_reads.append(last_r)
    flush_snp()
    if stats_path:
        write_align_stats(stats_path, stats, sub_hist)
    return stats


_ASCII_FWD = np.frombuffer(b"ACGTNNNN", np.uint8)          # code -> base
_ASCII_RC = np.frombuffer(b"TGCANNNN", np.uint8)           # code -> comp


def _align_blocks_raw(aligner: KAligner, src_path):
    """Zero-object block pipeline: uniform-length read blocks straight
    from io.fasta.read_seq_blocks into the device submit queue (two
    batches in flight, parsing on a producer thread). Yields
    (names: list[bytes], arr [B, L], quals [n, L] | None, raw, n)."""
    B = aligner.batch_size

    def padded(blocks):
        for names, codes, quals in blocks:
            n = len(names)
            if n < B:
                codes = np.concatenate(
                    [codes, np.repeat(codes[:1], B - n, axis=0)])
            yield (names, quals, n), codes, n

    def pipeline(blocks):
        for (names, quals, n), arr, raw in aligner._in_flight(padded(blocks)):
            yield names, arr, quals, raw, n

    yield from _prefetched(read_seq_blocks(src_path, B), pipeline)


def write_sam_fast(path, index: SfxIndex, aligner: KAligner, records,
                   cmdline: str = "", emit_unmapped: bool = True,
                   snp_caller=None, stats_path=None) -> dict:
    """Vectorized end-to-end fastq/fasta -> SAM: batches are classified as
    whole arrays and the SAM text is emitted by the native bulk formatter
    (native/hostops.cpp format_sam_se, the reference's AppendStr
    fast-writer scheme, KAligner.cpp:6338-6418). Byte-identical to the
    JAX package's write_sam_fast.

    `records` may be an iterable of SeqRecords OR a fastq/fasta path: a
    path with uniform-length reads takes the zero-object block route
    (io.fasta.read_seq_blocks); one with mixed lengths is read as records.
    Raises native.NativeUnavailable without the native library. Returns
    the class counts, keyed by NAR_NAMES. `snp_caller`
    (align.snp.SnpCaller) accumulates accepted alignments into its pileup;
    `stats_path` writes the substitution-distribution CSV (-O). A .bam
    path, or an aligner that needs hit lists (a rescue on, or
    `_force_full`), goes through `align_records` and the per-record
    `write_sam` (unsorted BAM, no index), as in JAX."""
    lib = native.load()
    src_path = records if isinstance(records, (str, os.PathLike)) \
        else None
    if str(path).endswith(".bam") or not aligner._use_compact():
        rec_iter = read_seqs(src_path) if src_path is not None else records
        return write_sam(path, index, aligner.align_records(rec_iter),
                         cmdline=cmdline, emit_unmapped=emit_unmapped,
                         snp_caller=snp_caller, stats_path=stats_path)

    blocks_gen = first_block = None
    if src_path is not None:
        blocks_gen = _align_blocks_raw(aligner, src_path)
        try:
            first_block = next(blocks_gen)
        except ValueError:        # non-uniform read lengths
            blocks_gen = None
            records = read_seqs(src_path)
        except StopIteration:     # empty input
            pass

    g = index.genome
    starts = g.starts.astype(np.int64)
    chrom_cat = "".join(g.names).encode()
    chrom_ofs = np.zeros(len(g.names) + 1, np.int64)
    chrom_ofs[1:] = np.cumsum([len(n) for n in g.names])
    stats = dict.fromkeys(NAR_NAMES, 0)
    sub_hist = np.zeros(64, np.int64)

    with open(path, "w", newline="") as f:
        f.write("@HD\tVN:1.4\tSO:unsorted\n")
        for name, ln in zip(g.names, g.lengths):
            f.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
        f.write(f"@PG\tID:kit4b_tpu\tPN:kit4b_tpu\tCL:{cmdline}\n")

    def emit(raw_f, names, arr, quals_all, raw, n):
        """Format + write one aligned block. names: list[bytes] (n);
        arr: uint8 [>=n, L] codes; quals_all: uint8 [n, L] raw phred+33
        ASCII or None; raw: compact result dict from the aligner."""
        with span("kalign.sam_prep"):
            L = arr.shape[1]
            nar = raw["nar"][:n]
            pos = raw["pos"][:n].astype(np.int64)
            strand = raw["strand"][:n].astype(np.int64)
            mm = np.asarray(raw["mm"][:n])
            cnt = np.bincount(nar, minlength=4)
            for c_i, key in enumerate(NAR_NAMES):
                stats[key] += int(cnt[c_i])
            acc = nar == 0
            sub_hist[:] = sub_hist + np.bincount(
                np.minimum(mm[acc], 63), minlength=64)
            sel = np.arange(n) if emit_unmapped else np.nonzero(acc)[0]
            if len(sel) == 0:
                return
            codes = arr[sel]
            acc_s = acc[sel]
            rev_s = acc_s & (strand[sel] == 1)
            # strand-oriented ASCII sequence, vectorized
            seq_ascii = _ASCII_FWD[codes]
            if rev_s.any():
                seq_ascii[rev_s] = _ASCII_RC[codes[rev_s][:, ::-1]]
            # first-byte 0 sentinel -> formatter emits "*" (no quality);
            # reverse-strand hits emit reversed qualities
            if quals_all is None:
                quals = np.zeros((len(sel), L), np.uint8)
            else:
                quals = np.ascontiguousarray(quals_all[sel])
                if rev_s.any():
                    quals[rev_s] = quals[rev_s][:, ::-1]
            ci = np.zeros(len(sel), np.int64)
            pos1 = np.zeros(len(sel), np.int64)
            if acc_s.any():
                p_acc = pos[sel][acc_s]
                c_acc = np.searchsorted(starts, p_acc, side="right") - 1
                ci[acc_s] = c_acc
                pos1[acc_s] = p_acc - starts[c_acc] + 1
            flag = np.where(acc_s, np.where(rev_s, FLAG_REVERSE, 0),
                            FLAG_UNMAPPED).astype(np.int32)
            mapq = np.full(len(sel), 254, np.int32)
            nm = mm[sel].astype(np.int32)
            ci32 = ci.astype(np.int32)
            seq_c = np.ascontiguousarray(seq_ascii)
            sel_names = [names[i] for i in sel] if len(sel) != n else names
            qn_cat = b"".join(sel_names)
            qn_ofs = np.zeros(len(sel) + 1, np.int64)
            qn_ofs[1:] = np.cumsum([len(x) for x in sel_names])
            # +16: the native guard checks against out+cap-1 with the full
            # per-record worst case, so an exact-fit cap is 1 byte short
            max_cn = max((len(c) for c in g.names), default=1)
            cap = int(qn_ofs[-1]) + len(sel) * (2 * L + max_cn + 128) + 16
            out = ctypes.create_string_buffer(cap)
            i32 = ctypes.POINTER(ctypes.c_int32)
            i64 = ctypes.POINTER(ctypes.c_int64)
            u8 = ctypes.POINTER(ctypes.c_uint8)
        with span("kalign.sam_format"):
            nb = lib.format_sam_se(
                qn_cat, qn_ofs.ctypes.data_as(i64),
                chrom_cat, chrom_ofs.ctypes.data_as(i64),
                flag.ctypes.data_as(i32), ci32.ctypes.data_as(i32),
                pos1.ctypes.data_as(i64), mapq.ctypes.data_as(i32),
                nm.ctypes.data_as(i32), seq_c.ctypes.data_as(u8),
                quals.ctypes.data_as(u8), len(sel), L, out, cap)
        if nb < 0:
            raise RuntimeError("format_sam_se buffer overflow")
        with span("kalign.sam_write"):
            raw_f.write(out.raw[:nb])
        if snp_caller is not None and acc_s.any():
            orient = codes[acc_s].copy()
            r2 = rev_s[acc_s]
            if r2.any():
                rc = orient[r2][:, ::-1]
                orient[r2] = np.where(rc < 4, 3 - rc, rc)
            snp_caller.add_alignments(pos[sel][acc_s], orient)

    # body appended via the native formatter
    with open(path, "ab") as raw_f:
        if blocks_gen is not None:
            if first_block is not None:
                emit(raw_f, *first_block)
                for blk in blocks_gen:
                    emit(raw_f, *blk)
        else:
            for recs, arr, raw in aligner.align_records_raw(records):
                n = len(recs)
                L = arr.shape[1]
                quals_all = None
                if any(r.qual is not None for r in recs):
                    quals_all = np.zeros((n, L), np.uint8)
                    for i, r in enumerate(recs):
                        if r.qual is not None and len(r.qual) == L:
                            quals_all[i] = np.asarray(r.qual, np.uint8) + 33
                emit(raw_f, [r.name.encode() for r in recs], arr,
                     quals_all, raw, n)
    if stats_path:
        write_align_stats(stats_path, stats, sub_hist)
    return stats
