"""Packed sequence store for the filter/assemble/scaffold pipeline: the
port's copy of kit4b_tpu/assembly/store.py (the `save`/`load` checkpoint
format is shared, so a store written by either package loads in the
other; tests/test_torch_rehomed.py holds both).

Capability parity with CKit4bdna's packed-read store (ngskit4b/kit4bdna.cpp:
2391 LoadReads, :1125/:969 SavePackedSeqsToFile/LoadPackedSeqsFromFile):
reads/contigs as a concatenated uint8 code array with an offsets directory,
per-seq flags, PE mate linkage, and versioned checkpoint save/load. The
reference's 15-bases-per-32-bit-word in-band format is replaced by plain
arrays (device packing happens at the op layer, ops/extend_packed.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import dna

STORE_VERSION = 1

# flag bits (CKit4bdna seq flags analog, kit4bdna.h:43-48)
FLAG_DELETED = 1 << 0     # removed (duplicate / non-overlapping / merged away)
FLAG_PE1 = 1 << 1
FLAG_PE2 = 1 << 2
FLAG_DUP = 1 << 3         # marked duplicate
FLAG_NOOVL = 1 << 4       # failed overlap support check
FLAG_MERGED = 1 << 5      # consumed by an assembly merge


@dataclass
class SeqStore:
    seq: np.ndarray                      # concatenated uint8 codes
    starts: np.ndarray                   # int64 [N]
    lengths: np.ndarray                  # int64 [N]
    flags: np.ndarray                    # uint32 [N]
    mate: np.ndarray | None = None       # int64 [N], index of PE mate or -1

    @classmethod
    def from_arrays(cls, arrays: list[np.ndarray],
                    flags: np.ndarray | None = None,
                    mate: np.ndarray | None = None) -> "SeqStore":
        n = len(arrays)
        lengths = np.asarray([len(a) for a in arrays], np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]) \
            if n else np.zeros(0, np.int64)
        seq = (np.concatenate(arrays).astype(np.uint8)
               if n else np.zeros(0, np.uint8))
        return cls(seq, starts, lengths,
                   flags if flags is not None else np.zeros(n, np.uint32),
                   mate)

    @classmethod
    def from_records(cls, records, pe_records=None,
                     min_phred: int = 0, max_ns_pct: int = 5,
                     trim5: int = 0, trim3: int = 0,
                     min_len: int = 30) -> "SeqStore":
        """Load reads with the filter-stage trims (ArtefactReduce load
        filters: phred/N/length/end-trims, kit4bdna.cpp:2391-…). PE input
        keeps mates adjacent (2i, 2i+1) and drops a pair when either mate
        fails."""
        def clean(rec):
            c = rec.codes[trim5: len(rec.codes) - trim3 if trim3 else None]
            q = rec.qual
            if q is not None and min_phred > 0:
                q = q[trim5: len(rec.qual) - trim3 if trim3 else None]
                keep = q >= min_phred
                # 3' quality trim: cut at first low-quality run end
                bad = np.nonzero(~keep)[0]
                if len(bad):
                    c = c[: bad[0]]
            if len(c) < min_len:
                return None
            if (c == dna.BASE_N).sum() * 100 > max_ns_pct * len(c):
                return None
            return c

        arrays: list[np.ndarray] = []
        flags: list[int] = []
        mate: list[int] = []
        if pe_records is None:
            for rec in records:
                c = clean(rec)
                if c is None:
                    continue
                arrays.append(c)
                flags.append(0)
                mate.append(-1)
        else:
            for r1, r2 in zip(records, pe_records):
                c1, c2 = clean(r1), clean(r2)
                if c1 is None or c2 is None:
                    continue
                i = len(arrays)
                arrays.append(c1)
                flags.append(FLAG_PE1)
                mate.append(i + 1)
                arrays.append(c2)
                flags.append(FLAG_PE2)
                mate.append(i)
        return cls.from_arrays(arrays, np.asarray(flags, np.uint32),
                               np.asarray(mate, np.int64))

    def __len__(self) -> int:
        return len(self.starts)

    def get(self, i: int) -> np.ndarray:
        s = int(self.starts[i])
        return self.seq[s: s + int(self.lengths[i])]

    def live_mask(self) -> np.ndarray:
        return (self.flags & FLAG_DELETED) == 0

    def n_live(self) -> int:
        return int(self.live_mask().sum())

    def compact(self) -> "SeqStore":
        """Drop deleted seqs (keeps PE mate adjacency: a deleted mate deletes
        the pair, as ArtefactReduce does for PE dup removal)."""
        live = self.live_mask()
        if self.mate is not None:
            # a pair survives only if both mates survive
            for i in np.nonzero(~live)[0]:
                m = int(self.mate[i])
                if m >= 0:
                    live[m] = False
        idxs = np.nonzero(live)[0]
        remap = -np.ones(len(self), np.int64)
        remap[idxs] = np.arange(len(idxs))
        arrays = [self.get(int(i)) for i in idxs]
        mate = None
        if self.mate is not None:
            mate = np.asarray([remap[self.mate[i]] if self.mate[i] >= 0
                               else -1 for i in idxs], np.int64)
        return SeqStore.from_arrays(arrays, self.flags[idxs].copy(), mate)

    # --- checkpoint (SavePackedSeqsToFile/LoadPackedSeqsFromFile parity) ---
    def save(self, path) -> None:
        # atomic: write to a temp path then rename, so a crash mid-write
        # can never leave a truncated checkpoint that a resume would load
        # (found by tests/test_multiproc.py::test_filter_kill_resume)
        path = str(path)
        final = path if path.endswith(".npz") else path + ".npz"
        tmp = final + ".tmp.npz"
        np.savez_compressed(tmp, version=np.int64(STORE_VERSION),
                            seq=self.seq, starts=self.starts,
                            lengths=self.lengths, flags=self.flags,
                            mate=(self.mate if self.mate is not None
                                  else np.zeros(0, np.int64)))
        os.replace(tmp, final)

    @classmethod
    def load(cls, path) -> "SeqStore":
        path = str(path)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"
        z = np.load(path)
        if int(z["version"]) != STORE_VERSION:
            raise ValueError(f"unsupported store version {int(z['version'])}")
        mate = z["mate"]
        return cls(z["seq"], z["starts"], z["lengths"], z["flags"],
                   mate if len(mate) else None)

    def to_fasta_records(self, prefix: str = "seq"):
        from ..io.fasta import SeqRecord
        out = []
        for i in np.nonzero(self.live_mask())[0]:
            out.append(SeqRecord(f"{prefix}{i+1:07d}", "", self.get(int(i))))
        return out
