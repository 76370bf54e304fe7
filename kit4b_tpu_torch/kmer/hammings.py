"""hammings: genome-wide minimum K-mer Hamming distances.

Port of kit4b_tpu/kmer/hammings.py. `hammings_exhaustive` runs the
max-match engine (hammings_mxu.py), or with `legacy_sweep` and
`use_kernel` the offset-sweep engine (hammings_kernel.py). The naive
oracle, the node merge and the .csv/.hmg/.npy readers and writers are
numpy code re-homed here from kit4b_tpu/kmer/hammings.py, whose module
imports jax; the tests hold them byte-identical to the originals.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from kit4b_tpu import dna

from .hammings_kernel import hammings_exhaustive_kernel
from .hammings_mxu import hammings_exhaustive_mxu

BIG = np.uint16(0xFFFF)


def hammings_exhaustive(genome_seq: np.ndarray, K: int,
                        *, antisense: bool = True,
                        node: int = 0, numnodes: int = 1,
                        use_kernel: bool | None = None,
                        legacy_sweep: bool = False,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Minimum Hamming distance per K-mer start position (uint16, 0xFFFF
    where no valid K-mer), by the max-match engine. Node partitioning
    splits partner-span ranges; merge partials with np.minimum (ePMmerge).

    legacy_sweep=True with use_kernel runs the offset-sweep engine. As in
    the JAX package, that engine ignores node/numnodes: every node returns
    the whole-genome minimum, which merges to the same result. The legacy
    XLA sweep (legacy_sweep without use_kernel) is not ported."""
    G = len(genome_seq)
    if G < K:
        return np.full(0, BIG, np.uint16)
    if not legacy_sweep:
        return hammings_exhaustive_mxu(np.asarray(genome_seq), K,
                                       antisense=antisense, node=node,
                                       numnodes=numnodes, device=device)
    if use_kernel:
        return hammings_exhaustive_kernel(np.asarray(genome_seq), K,
                                          antisense=antisense, device=device)
    raise NotImplementedError(
        "hammings legacy XLA sweep (kit4b_tpu/kmer/hammings.py "
        "_sweep_range) is not ported; use_kernel=True runs the offset-sweep "
        "engine")


def hammings_oracle(genome_seq: np.ndarray, K: int,
                    antisense: bool = True) -> np.ndarray:
    """Naive NumPy oracle for tests."""
    g = np.asarray(genome_seq)
    G = len(g)
    sent = g >= dna.BASE_UNDEF  # UNDEF/INDEL/EOS/EOG all invalidate windows
    nk = G - K + 1
    if nk <= 0:
        return np.zeros(0, np.uint16)
    wins = np.lib.stride_tricks.sliding_window_view(g, K)
    valid = ~np.lib.stride_tricks.sliding_window_view(sent, K).any(axis=1)
    out = np.full(G, BIG, np.uint16)
    rev = wins[:, ::-1]
    rc_wins = np.where(rev < 4, 3 - rev, rev)  # N and sentinels unchanged
    for i in range(nk):
        if not valid[i]:
            continue
        best = int(BIG)
        for j in range(nk):
            if not valid[j]:
                continue
            if j != i:
                best = min(best, int((wins[i] != wins[j]).sum()))
            if antisense:
                best = min(best, int((wins[i] != rc_wins[j]).sum()))
        out[i] = best
    return out


def merge(*partials: np.ndarray) -> np.ndarray:
    """ePMmerge equivalent: elementwise min over per-node results."""
    out = partials[0].copy()
    for p in partials[1:]:
        if len(p) != len(out):
            raise ValueError("hammings merge: dimension mismatch")
        np.minimum(out, p, out=out)
    return out


def write_csv(path, genome, hmin: np.ndarray, K: int) -> None:
    """Per-position CSV (chrom, offset, Hamming) like the reference's
    trans-to-CSV mode (hammings.cpp:105)."""
    names, dists = split_by_chrom(genome, hmin, K)
    write_csv_dists(path, names, dists)


def split_by_chrom(genome, hmin: np.ndarray, K: int):
    """Flat concatenated-genome hmin -> (names, per-chrom uint16 arrays of
    NumEls = chrom_len - K + 1)."""
    names, dists = [], []
    for ci, name in enumerate(genome.names):
        s = int(genome.starts[ci])
        ln = int(genome.lengths[ci])
        n_els = max(0, ln - K + 1)
        names.append(name)
        dists.append(np.asarray(hmin[s:s + n_els], np.uint16))
    return names, dists


def write_csv_dists(path, names, dists) -> None:
    with open(path, "w") as f:
        f.write("\"chrom\",\"offset\",\"Hamming\"\n")
        for name, d in zip(names, dists):
            for off in range(len(d)):
                if d[off] == BIG:
                    continue
                f.write(f"\"{name}\",{off},{int(d[off])}\n")


def read_csv_dists(path):
    """Inverse of write_csv_dists -> (names, per-chrom uint16 arrays);
    offsets absent from the CSV read back as the BIG sentinel."""
    per: dict[str, dict[int, int]] = {}
    order: list[str] = []
    with open(path) as f:
        f.readline()
        for line in f:
            c = line.rstrip("\n").split(",")
            if len(c) < 3:
                continue
            name = c[0].strip('"')
            if name not in per:
                per[name] = {}
                order.append(name)
            per[name][int(c[1])] = int(c[2])
    names, dists = [], []
    for name in order:
        d = per[name]
        arr = np.full(max(d) + 1 if d else 0, BIG, np.uint16)
        for off, v in d.items():
            arr[off] = v
        names.append(name)
        dists.append(arr)
    return names, dists


# --- reference .hmg binary interop (ngskit4b/hammings.cpp:78-94) ---------
_HMG_MAGIC = b"bham"
_HMG_MAX_CHROMS = 1000           # cMaxHHammingChroms
_HMG_NAME_LEN = 81               # cMaxDatasetSpeciesChrom
_HMG_HDR_LEN = 4 + 4 + 4 + 2 + 4 * _HMG_MAX_CHROMS
_HMG_CHROM_FIXED = 4 + _HMG_NAME_LEN + 4


def write_hmg(path, names, dists) -> None:
    """Reference quick-load binary Hamming file (tsHHamHdr/tsHHamChrom,
    ngskit4b/hammings.cpp:78-94, packed layout, Version 1) — byte
    interoperable with the reference's ePMtrans/ePMmerge modes."""
    if len(names) > _HMG_MAX_CHROMS:
        raise ValueError(f"hmg holds at most {_HMG_MAX_CHROMS} chroms")
    chrom_blobs = []
    for cid, (name, d) in enumerate(zip(names, dists), start=1):
        nm = name.encode()[:_HMG_NAME_LEN - 1]
        nm = nm + b"\0" * (_HMG_NAME_LEN - len(nm))
        d = np.asarray(d, np.uint16)
        chrom_blobs.append(struct.pack("<I", cid) + nm
                           + struct.pack("<I", len(d))
                           + d.astype("<u2").tobytes())
    ofs = []
    cur = _HMG_HDR_LEN
    for b in chrom_blobs:
        ofs.append(cur)
        cur += len(b)
    hdr = (_HMG_MAGIC + struct.pack("<I", 1) + struct.pack("<i", cur)
           + struct.pack("<H", len(names))
           + struct.pack(f"<{_HMG_MAX_CHROMS}I",
                         *(ofs + [0] * (_HMG_MAX_CHROMS - len(ofs)))))
    if len(hdr) != _HMG_HDR_LEN:
        raise ValueError(f"hmg header is {len(hdr)} bytes, not {_HMG_HDR_LEN}")
    with open(path, "wb") as f:
        f.write(hdr)
        for b in chrom_blobs:
            f.write(b)


def read_hmg(path):
    """Inverse of write_hmg -> (names, per-chrom uint16 arrays)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _HMG_MAGIC:
        raise ValueError(f"{path}: not a .hmg Hamming file")
    n_chroms = struct.unpack_from("<H", raw, 12)[0]
    ofs = struct.unpack_from(f"<{_HMG_MAX_CHROMS}I", raw, 14)
    names, dists = [], []
    for i in range(n_chroms):
        o = ofs[i]
        name = raw[o + 4:o + 4 + _HMG_NAME_LEN].split(b"\0")[0].decode()
        n_els = struct.unpack_from("<I", raw, o + 4 + _HMG_NAME_LEN)[0]
        d = np.frombuffer(raw, "<u2", n_els, o + _HMG_CHROM_FIXED)
        names.append(name)
        dists.append(d.astype(np.uint16))
    return names, dists


def load_dists(path):
    """(names, dists) from .hmg binary, .csv, or .npy flat array."""
    p = str(path)
    if p.endswith(".csv"):
        return read_csv_dists(p)
    with open(p, "rb") as f:
        magic = f.read(4)
    if magic == _HMG_MAGIC:
        return read_hmg(p)
    arr = np.load(p)
    return None, [np.asarray(arr, np.uint16)]   # flat single-chunk


def save_dists(path, names, dists) -> None:
    p = str(path)
    if p.endswith(".csv"):
        write_csv_dists(p, names, dists)
    elif p.endswith(".npy"):
        np.save(p, np.concatenate([np.asarray(d, np.uint16)
                                   for d in dists]))
    else:
        write_hmg(p, names or [f"c{i+1}" for i in range(len(dists))],
                  dists)


def merge_dists(loaded):
    """ePMmerge over (names, dists) tuples: elementwise min per chrom."""
    names, dists = loaded[0]
    dists = [np.asarray(d, np.uint16).copy() for d in dists]
    for nm2, d2 in loaded[1:]:
        if nm2 is not None and names is not None and nm2 != names:
            raise ValueError("hammings merge: chromosome sets differ")
        if len(d2) != len(dists):
            raise ValueError("hammings merge: chrom count mismatch")
        for a, b in zip(dists, d2):
            if len(a) != len(b):
                raise ValueError("hammings merge: dimension mismatch")
            np.minimum(a, np.asarray(b, np.uint16), out=a)
    return names, dists
