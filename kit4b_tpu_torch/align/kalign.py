"""kalign: seed-and-extend short-read aligner, single-end,
substitutions only, on PyTorch.

Port of kit4b_tpu/align/kalign.py's compact path. A read batch is packed
2 bits a base on the host (native `pack2bit_u8`), uploaded, and aligned on
the device by one tier-1 pass (`seed_extend_v5.fast_pass_packed_v5` when
the index's bucket histogram predicts few escalations, else
`seed_extend_v4.fast_pass_packed_v4`), which returns one [B, 2] int32 row
per read with the in-graph tier 2 applied. Rows still marked -3 climb the
host escalation ladder `((512, 512), (64, 8192))` through
`seed_extend_fast.fast_pass`, the last tier capped per bucket. SAM text is
formatted by the native `format_sam_se`.

The host helpers of the JAX module (`pack_reads_2bit`, the pass schedule)
are re-homed here because that module imports jax at module top; tests hold
them byte-identical to their originals. Every device tensor lives on the
aligner's explicit `device` (CUDA by default; `device.resolve` raises when
it is absent).

Not ported (ROADMAP queue A): the full-stats tier 1 `fast_pass_v3` and the
microInDel, splice and chimeric rescues that need its hit lists (item 12),
the `fast_pass_compact_v3` / `fast_pass_compact` branches for genomes with
2*G+1 >= 2^31 or more than 2^31 clean suffixes (item 12), `align_batch`'s
raw hit lists, which paired ends of unequal length need (item 12), and
`filter_alignments` and BAM output (item 20). Paired ends are
`align.pe`.
"""
from __future__ import annotations

import ctypes
import os
import queue
import threading
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from .. import dna, native
from ..device import resolve
from ..index.sfx_index import SfxIndex
from ..io.fasta import SeqRecord, read_seq_blocks, read_seqs
from ..io.sam import FLAG_REVERSE, FLAG_UNMAPPED
from ..ops import seed_extend_fast, seed_extend_v4, seed_extend_v5
from ..ops.extend_packed import pack_genome
from ..ops.seed_extend_v3 import make_lut2_device, unpack_result2

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
NAR_ACCEPTED = NAR_NAMES[0]


@dataclass
class AlignResult:
    """One read's placement: the fields of kit4b_tpu's AlignResult that
    the paired-end path sets."""
    nar: str
    strand: int = 0        # 0 = '+', 1 = '-'
    pos: int = -1          # concatenated-genome start
    mm: int = -1
    n_low: int = 0


class KAligner:
    """Batch seed-and-extend aligner over a loaded SfxIndex, on `device`.

    Reads whose candidate total exceeds the tier capacity are escalated
    through `escalation` (batch, capacity) tiers (the reference's MaxIter
    ladder, ngskit4b/KAligner.h:53-56); reads still overflowing the last
    tier are classified multi."""

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
                    "genomes with 2*G+1 >= 2^31 or 2^31 clean suffixes "
                    "need the fast_pass_compact_v3 / fast_pass_compact "
                    "branches, not ported yet: ROADMAP.md queue A item 12")
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

    # --- device pass (submit / collect split for pipelining) ---------------
    def _submit(self, reads: np.ndarray, n_compact: int | None = None,
                compact: bool = True, capped: bool = False):
        """Starts a batch on the device. compact: the tier-1 pass, returning
        ("packed", [B, 2] rows); else a full-stats escalation tier at
        n_compact, returning fast_pass's dict. Nothing here waits for the
        device."""
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
        if not compact:
            return seed_extend_fast.fast_pass(
                gview, sa, lut, torch.from_numpy(reads).to(self.device),
                max_ml=self.max_ml, max_per_bucket=cap, **kw)
        if n_compact is not None:
            raise NotImplementedError(
                "a compact pass at another capacity (fast_pass_compact) is "
                "not ported: ROADMAP.md queue A item 12")
        reads2b, nlist = pack_reads_2bit(reads)
        r2b = torch.from_numpy(reads2b).to(self.device)
        nl = torch.from_numpy(nlist).to(self.device)
        common = dict(read_len=L, max_tot_mm=max_tot_mm,
                      mm_delta=self.mm_delta, n_extend=self.n_extend, **kw)
        lut4 = self._lut4_for(L, sa)
        if lut4 is not None:
            return ("packed", seed_extend_v5.fast_pass_packed_v5(
                gview, sa, lut2, lut4, r2b, nl, tier2=TIER2, **common))
        return ("packed", seed_extend_v4.fast_pass_packed_v4(
            gview, sa, lut2, r2b, nl, max_per_bucket=cap, tier2=TIER2_V4,
            **common))

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

    def _collect_compact(self, devout, reads: np.ndarray) -> dict:
        """Fetch [B, 2] compact rows (waits for the device); escalate -3
        rows through the host ladder; return the classification dict."""
        code, low, n_low = unpack_result2(devout[1].cpu().numpy())
        B, L = reads.shape
        _, max_tot_mm = self.schedule_for(L)
        for ti, (bt, nct) in enumerate(self.escalation):
            idxs = np.nonzero(code == -3)[0]
            if len(idxs) == 0:
                break
            final = ti == len(self.escalation) - 1
            for s in range(0, len(idxs), bt):
                chunk = idxs[s:s + bt]
                sub = reads[chunk]
                if len(chunk) < bt:
                    sub = np.concatenate(
                        [sub, np.repeat(sub[:1], bt - len(chunk), axis=0)])
                out2 = {k: v.cpu().numpy() for k, v in self._submit(
                    sub, n_compact=nct, compact=False,
                    capped=final).items()}
                code[chunk] = self._code_from_full(
                    {k: v[:len(chunk)] for k, v in out2.items()}, max_tot_mm)
                low[chunk] = out2["low_mm"][:len(chunk)]
                n_low[chunk] = out2["n_low"][:len(chunk)]
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        ns_bad = (reads == dna.BASE_N).sum(axis=1) > max_ns_seq
        # final-tier overflow (-3) is classified multi, as the reference
        # classifies MaxIter-truncated reads
        nar = np.where(ns_bad, 3,
                       np.where(code >= 0, 0,
                                np.where(code == -1, 1, 2))).astype(np.uint8)
        pos = np.where(code >= 0, code >> 1, -1)
        strand = np.where(code >= 0, code & 1, 0)
        return {"nar": nar, "pos": pos, "strand": strand, "mm": low,
                "low_mm": low, "n_low": n_low, "nxt_mm": None,
                "hit_id": None, "hit_mm": None,
                "overflow": code == -3, "max_tot_mm": max_tot_mm}

    def align_batch_raw(self, reads: np.ndarray) -> dict:
        """Vectorized alignment of a [B, L] uint8 code batch: numpy arrays
        nar [B] uint8 (0=accepted 1=nohit 2=multi 3=excess-Ns),
        pos/strand/mm [B] (valid where accepted), low_mm, n_low, overflow."""
        return self._collect_compact(self._submit(reads), reads)

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

    def _in_flight(self, batches):
        """(meta, padded [B, L] batch) pairs -> (meta, batch, classification
        dict), with two device batches in flight: batch k+1 is submitted
        before batch k is collected."""
        pending: deque = deque()
        for meta, arr in batches:
            pending.append((meta, arr, self._submit(arr)))
            if len(pending) >= 2:
                meta0, arr0, dev0 = pending.popleft()
                yield meta0, arr0, self._collect_compact(dev0, arr0)
        while pending:
            meta0, arr0, dev0 = pending.popleft()
            yield meta0, arr0, self._collect_compact(dev0, arr0)

    def align_records_raw(self, records: Iterable[SeqRecord]):
        """Batched streaming for the SAM writer, batching by read length:
        yields (recs, padded batch, classification dict) per batch, two
        device batches in flight and record parsing on a background
        thread."""
        def pipeline(source):
            return self._in_flight((bl, self._pad_batch(bl)) for bl in source)

        yield from _prefetched(self._batches(records), pipeline)


def _prefetched(source, consume):
    """Runs `source` on a background thread (two items ahead) and yields
    from consume(items); re-raises the producer's exception at the end."""
    q: queue.Queue = queue.Queue(maxsize=2)
    sentinel = object()
    err: list[BaseException] = []

    def producer():
        try:
            for item in source:
                q.put(item)
        except BaseException as e:   # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def items():
        while True:
            item = q.get()
            if item is sentinel:
                return
            yield item

    yield from consume(items())
    t.join()
    if err:
        raise err[0]


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
            yield (names, quals, n), codes

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
    `stats_path` writes the substitution-distribution CSV (-O). The port
    has this one SAM writer: the JAX package's per-record `write_sam`
    serves the filters and phases of ROADMAP.md queue A item 20."""
    if str(path).endswith(".bam"):
        raise NotImplementedError("BAM output is not ported yet: "
                                  "ROADMAP.md queue A item 20")
    lib = native.load()
    src_path = records if isinstance(records, (str, os.PathLike)) \
        else None

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
        nb = lib.format_sam_se(
            qn_cat, qn_ofs.ctypes.data_as(i64),
            chrom_cat, chrom_ofs.ctypes.data_as(i64),
            flag.ctypes.data_as(i32), ci32.ctypes.data_as(i32),
            pos1.ctypes.data_as(i64), mapq.ctypes.data_as(i32),
            nm.ctypes.data_as(i32), seq_c.ctypes.data_as(u8),
            quals.ctypes.data_as(u8), len(sel), L, out, cap)
        if nb < 0:
            raise RuntimeError("format_sam_se buffer overflow")
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
