"""Bisulfite alignment (reference kalign -b + index -m1 bisulfite), on
PyTorch: the port of kit4b_tpu/align/bisulfite.py.

The reference collapses BOTH conversions into one suffix array (T->C and
A->G simultaneously, libkit4b/SfxArray.cpp:511-535), leaving a 2-symbol
alphabet whose k-mer buckets are enormous. The JAX package uses the
standard two-index scheme instead (as Bismark/BWA-meth do), and so does
the port:

  watson-origin reads:  read C->T collapsed  vs  genome C->T collapsed
  crick-origin reads :  revcomp(read) G->A   vs  genome G->A collapsed

Each direction is a one-strand `seed_extend_fast.fast_candidates` over its
own collapsed LUT/SA (radix 3, `BsIndex.DMAP_CT` / `DMAP_GA`); candidates
are concatenated (disjoint by strand bit) and classified together
(`bs_pass_compact`, plain PyTorch on the aligner's device), so n_low /
next-best span both directions as the reference's joint search does.
Mismatch counts are over the collapsed alphabet: C/T (resp. G/A)
differences are free. The result is bit-identical to the JAX package's.

What the JAX package does and the port keeps (ROADMAP queue C):
- There is no host escalation ladder: a read whose seeds fill more than
  `n_compact` slots comes back as code -3 and is classified multi.
- `BsAligner` builds its genome view for the first read length it sees.
  A later batch whose word count differs gives shapes that do not
  broadcast, and JAX raises inside the pass; `BsAligner` raises a
  ValueError for exactly those batches. Reads of at most 16 bp (one
  word) after longer ones broadcast in JAX and are classified from the
  first length's view; the port does the same.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import dna
from ..device import resolve
from ..index.sfx_index import SfxIndex, pick_lut_k
from ..io.fasta import Genome
from ..ops import seed_extend_fast as F
from ..ops.extend_packed import pack_genome
from .kalign import build_pass_schedule

MIXED_LENGTHS = ("ROADMAP.md queue C, 'Bisulfite: the genome view of the "
                 "first read length': the JAX package's BsAligner keeps the "
                 "view of the first read length and fails on a batch of "
                 "another word count")


def collapse_ct(codes: np.ndarray) -> np.ndarray:
    """C -> T (code 1 -> 3); sentinels/N unchanged."""
    out = np.asarray(codes).copy()
    out[out == 1] = 3
    return out


def collapse_ga(codes: np.ndarray) -> np.ndarray:
    """G -> A (code 2 -> 0); sentinels/N unchanged."""
    out = np.asarray(codes).copy()
    out[out == 2] = 0
    return out


class BsIndex:
    """Two collapsed-genome indexes + the original genome.

    Saved as .kbx (npz bundle of the two .kix payloads), the JAX package's
    format: an index that either package writes loads in the other."""

    def __init__(self, genome: Genome, idx_ct: SfxIndex, idx_ga: SfxIndex):
        self.genome = genome
        self.ct = idx_ct
        self.ga = idx_ga
        self.lut_k = idx_ct.lut_k

    # monotone code->digit maps for the two collapsed alphabets
    DMAP_CT = (0, 0, 1, 2)   # {A,G,T} after C->T; C never occurs
    DMAP_GA = (0, 1, 1, 2)   # {A,C,T} after G->A; G never occurs

    @classmethod
    def build(cls, genome: Genome, lut_k: int | None = None) -> "BsIndex":
        if lut_k is None:
            # 3-symbol alphabet: grow k so 3^k matches 4^k4 bucket load
            lut_k = min(16, math.ceil(pick_lut_k(len(genome.seq))
                                      * math.log(4) / math.log(3)))
        g_ct = Genome(genome.names, genome.starts, genome.lengths,
                      collapse_ct(genome.seq))
        g_ga = Genome(genome.names, genome.starts, genome.lengths,
                      collapse_ga(genome.seq))
        return cls(genome,
                   SfxIndex.build(g_ct, lut_k, lut_base=3,
                                  digit_map=cls.DMAP_CT),
                   SfxIndex.build(g_ga, lut_k, lut_base=3,
                                  digit_map=cls.DMAP_GA))

    def save(self, path) -> None:
        np.savez_compressed(
            path, version=np.int64(1), lut_k=np.int64(self.lut_k),
            seq=self.genome.seq,
            chrom_names=np.array(self.genome.names, dtype=object),
            chrom_starts=self.genome.starts,
            chrom_lengths=self.genome.lengths,
            sa_ct=self.ct.sa_clean, lut_ct=self.ct.lut,
            sa_ga=self.ga.sa_clean, lut_ga=self.ga.lut,
            allow_pickle=True)

    @classmethod
    def load(cls, path) -> "BsIndex":
        path = str(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        g = Genome(list(z["chrom_names"]), z["chrom_starts"],
                   z["chrom_lengths"], z["seq"])
        k = int(z["lut_k"])
        g_ct = Genome(g.names, g.starts, g.lengths, collapse_ct(g.seq))
        g_ga = Genome(g.names, g.starts, g.lengths, collapse_ga(g.seq))
        return cls(g, SfxIndex(g_ct, k, z["sa_ct"], z["lut_ct"],
                               lut_base=3, digit_map=cls.DMAP_CT),
                   SfxIndex(g_ga, k, z["sa_ga"], z["lut_ga"],
                            lut_base=3, digit_map=cls.DMAP_GA))


def bs_pass_compact(gview_ct, sa_ct, lut_ct, gview_ga, sa_ga, lut_ga,
                    reads_ct, reads_garc, *, genome_len: int, offsets: tuple,
                    lut_k: int, n_compact: int, max_tot_mm: int,
                    mm_delta: int) -> torch.Tensor:
    """Both bisulfite directions in one pass; [B, 3] int32 rows (code, low
    mm, n_low), code = best locus id pos*2+strand when unique, -1 no hit,
    -2 multi, -3 overflow (the contract of the JAX package's
    fast_pass_compact)."""
    kw = dict(genome_len=genome_len, offsets=offsets, lut_k=lut_k,
              n_compact=n_compact, lut_base=3)
    ids_w, mm_w, ovf_w = F.fast_candidates(
        gview_ct, sa_ct, lut_ct, reads_ct,
        single_strand=0, digit_map=BsIndex.DMAP_CT, **kw)
    ids_c, mm_c, ovf_c = F.fast_candidates(
        gview_ga, sa_ga, lut_ga, reads_garc,
        single_strand=1, digit_map=BsIndex.DMAP_GA, **kw)
    ids = torch.cat([ids_w, ids_c], dim=1)
    mm = torch.cat([mm_w, mm_c], dim=1)
    overflow = ovf_w | ovf_c
    ok = ids != F.INT32_MAX
    low = mm.amin(1)
    at_low = mm == low[:, None]
    n_low = (at_low & ok).sum(1, dtype=torch.int32)
    nxt = torch.where(mm > low[:, None], mm, F.INT32_MAX).amin(1)
    best = torch.where(at_low, ids, F.INT32_MAX).amin(1)
    aligned = low <= max_tot_mm
    unique = aligned & ~overflow & (n_low == 1) & ((nxt - low) >= mm_delta)
    code = torch.where(overflow, -3,
                       torch.where(unique, best,
                                   torch.where(aligned, -2, -1)))
    return torch.stack([code.to(torch.int32), low, n_low], dim=1)


class BsAligner:
    """SE bisulfite aligner over a BsIndex (kalign -b capability), on
    `device` (CUDA by default; `device.resolve` raises when it is absent)."""

    def __init__(self, index: BsIndex, *, max_subs: int = 5,
                 mm_delta: int = 1, max_ns: int = 1,
                 n_compact: int = 24, batch_size: int = 16384,
                 device: str | torch.device = "cuda"):
        self.index = index
        self.max_subs = max_subs
        self.mm_delta = mm_delta
        self.max_ns = max_ns
        self.n_compact = n_compact
        self.batch_size = batch_size
        self.device = resolve(device)
        self._dev = None
        self._nw2 = None      # the word count the genome views were built for

    def _device(self, read_len: int):
        """(gview, sa, lut) of both collapsed indexes on the device, built
        for the first read length's word count, as the JAX package does."""
        nw2 = (read_len + 15) // 16 + 1
        if self._dev is None:
            dv = []
            for idx in (self.index.ct, self.index.ga):
                gp, gb = pack_genome(idx.genome.seq, 65)
                dv.append((F.make_gview_device(gp, gb, nw2, self.device),
                           torch.from_numpy(idx.sa_clean.astype(np.int32))
                           .to(self.device),
                           torch.from_numpy(idx.lut.astype(np.int32))
                           .to(self.device)))
            self._dev = tuple(dv)
            self._nw2 = nw2
        elif nw2 != self._nw2 and nw2 != 2:
            # JAX fails here to broadcast the first length's rows; reads of
            # one word (nw2 2) broadcast and go on with those rows
            first = ((self._nw2 - 2) * 16 + 1, (self._nw2 - 1) * 16)
            raise ValueError(
                f"bisulfite reads of {read_len} bp after reads of "
                f"{first[0]}-{first[1]} bp: {MIXED_LENGTHS}; align each "
                "read length in a run of its own")
        return self._dev

    def align_batch_raw(self, reads: np.ndarray) -> dict:
        """[B, L] uint8 codes -> the classification dict of the JAX
        package's align_batch_raw (nar, pos, strand, mm, n_low,
        max_tot_mm)."""
        B, L = reads.shape
        _, max_tot = build_pass_schedule(
            L, self.max_subs, self.mm_delta, len(self.index.genome.seq))
        offsets = F.fast_offsets(L, self.index.lut_k,
                                 max_tot + max(self.mm_delta - 1, 0))
        (gv_ct, sa_ct, lut_ct), (gv_ga, sa_ga, lut_ga) = self._device(L)
        r = torch.from_numpy(np.ascontiguousarray(reads)).to(self.device)
        reads_ct = torch.where(r == 1, 3, r)
        rc = F.revcomp_device(r)
        reads_garc = torch.where(rc == 2, 0, rc)
        out = bs_pass_compact(
            gv_ct, sa_ct, lut_ct, gv_ga, sa_ga, lut_ga, reads_ct, reads_garc,
            genome_len=len(self.index.genome.seq), offsets=offsets,
            lut_k=self.index.lut_k, n_compact=self.n_compact,
            max_tot_mm=max_tot, mm_delta=self.mm_delta).cpu().numpy()
        code = out[:, 0].astype(np.int64)
        low = out[:, 1].astype(np.int64)
        n_low = out[:, 2].astype(np.int64)
        max_ns_seq = max(L * self.max_ns // 100, self.max_ns)
        ns_bad = (reads == dna.BASE_N).sum(axis=1) > max_ns_seq
        nar = np.where(ns_bad, 3,
                       np.where(code >= 0, 0,
                                np.where(code == -1, 1, 2))).astype(np.uint8)
        return {"nar": nar, "pos": np.where(code >= 0, code >> 1, -1),
                "strand": np.where(code >= 0, code & 1, 0),
                "mm": low, "n_low": n_low, "max_tot_mm": max_tot}
