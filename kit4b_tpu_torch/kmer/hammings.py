"""hammings: genome-wide minimum K-mer Hamming distances.

Port of kit4b_tpu/kmer/hammings.py. `hammings_exhaustive` runs the
max-match engine (hammings_mxu.py), or with `legacy_sweep` and
`use_kernel` the offset-sweep engine (hammings_kernel.py).
`hammings_restricted` (`hammings -r`) probes the suffix index through the
seed-and-extend pass `ops.seed_extend_fast.fast_pass`. The naive oracle,
the node merge and the .csv/.hmg/.npy readers and writers are numpy code
re-homed here from kit4b_tpu/kmer/hammings.py, whose module imports jax;
the tests hold them byte-identical to the originals.
"""
from __future__ import annotations

import struct
from collections import deque

import numpy as np
import torch

from .. import dna
from ..device import resolve
from ..ops import seed_extend_fast as F
from ..utils.runtime import span
from .hammings_kernel import hammings_exhaustive_kernel
from .hammings_mxu import hammings_exhaustive_mxu
from .kmarkers import _fast_device_arrays

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


def hammings_restricted(index, K: int, *, max_hamming: int = 3,
                        batch: int = 16384, antisense: bool = True,
                        n_compact: int = 64,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """Restricted-mode hammings (ngskit4b hammings ePMrestrict;
    CSfxArray::LocateSfxHammings SfxArray.cpp:4107): per K-mer position,
    the minimum Hamming distance up to `max_hamming` (values above
    report max_hamming + 1), found by pigeonhole suffix-array probes.

    Core scheduling follows the reference's core-length-by-SA-search
    compromise (hammings.cpp:399): W = min(max_hamming+1, K//lut_k)
    disjoint seed windows guarantee discovery of every hit with
    mm <= W-1; when K is too short for max_hamming+1 full-width cores,
    hits in (W-1, max_hamming] are found best-effort exactly as the
    reference's shortened cores are.

    K-mers containing 1..4 indeterminate bases enumerate all canonical
    substitutions and take the minimum over variants; >4 Ns score 0
    (SfxArray.cpp:4152-4177).

    The probes run `fast_pass` at n_compact with `max_per_bucket =
    n_compact // (2W)` and ignore its overflow: a bucket is cut to its
    first entries, so which hits are seen depends on the slot order
    (strand, window, bucket rank) and on the order of the suffixes within
    a bucket. `index` must therefore be the lexicographic suffix index of
    `SfxIndex.build` (SA-IS), as the CLI builds it; `build_buckets`, whose
    buckets are in position order, gives other answers wherever a bucket
    is cut.

    Windows gather on `device` from the resident genome, and two batches
    are in flight. Returns uint16 [G]."""
    dev = resolve(device)
    g = index.genome
    G = len(g.seq)
    nk = G - K + 1
    out = np.full(G, BIG, np.uint16)
    if nk <= 0:
        return out
    gview_d, sa_d, lut_d = _fast_device_arrays(index, K, dev)
    W = min(max_hamming + 1, max(1, K // index.lut_k))
    cl = K // W
    offsets = tuple(min(j * cl, K - index.lut_k) for j in range(W))

    def run_batches(positions, reads_of, fold_min):
        """positions int64 [N] (host); reads_of(s, e) -> device uint8
        [e - s, K], the queries of positions[s:e]; fold_min(chunk,
        best_mm) folds per-query minima into out."""
        pending = deque()

        def submit(s):
            chunk = positions[s:s + batch]
            nb = len(chunk)
            reads = reads_of(s, s + nb)
            if nb < batch:
                reads = torch.cat([reads, reads[:1].expand(batch - nb, K)])
            return chunk, nb, F.fast_pass(
                gview_d, sa_d, lut_d, reads,
                genome_len=G, offsets=offsets, lut_k=index.lut_k,
                n_compact=n_compact, max_ml=8,
                max_per_bucket=max(1, n_compact // (2 * W)))

        def drain(chunk, nb, dev_out):
            hid = dev_out["hit_id"][:nb].cpu().numpy()
            hmm = dev_out["hit_mm"][:nb].cpu().numpy().astype(np.int64)
            valid = hid != F.INT32_MAX
            pos = np.where(valid, hid >> 1, -1)
            strand = np.where(valid, hid & 1, 0)
            use = valid & (hmm <= max_hamming)
            # exclude the query's own sense locus
            use &= ~((strand == 0) & (pos == chunk[:, None]))
            if not antisense:
                use &= strand == 0
            mm = np.where(use, hmm, max_hamming + 1)
            with span("restricted.fold"):
                fold_min(chunk, mm.min(axis=1))

        for s in range(0, len(positions), batch):
            with span("restricted.submit"):
                pending.append(submit(s))
            if len(pending) >= 2:
                with span("restricted.drain"):
                    drain(*pending.popleft())
        while pending:
            with span("restricted.drain"):
                drain(*pending.popleft())

    # classify windows by N content (vectorized)
    isn = (g.seq >= 4).astype(np.int64)
    cn = np.concatenate([[0], np.cumsum(isn)])
    n_in_win = cn[K:nk + K] - cn[:nk]
    clean_pos = np.nonzero(n_in_win == 0)[0].astype(np.int64)
    some_n = np.nonzero((n_in_win >= 1) & (n_in_win <= 4))[0]
    many_n = np.nonzero(n_in_win > 4)[0]

    def fold_direct(chunk, best):
        out[chunk] = np.minimum(out[chunk],
                                best.astype(np.uint16))

    if len(clean_pos):
        genome_d = torch.from_numpy(g.seq).to(dev)
        clean_d = torch.from_numpy(clean_pos).to(dev)      # one copy
        lane = torch.arange(K, device=dev)
        run_batches(clean_pos,
                    lambda s, e: genome_d[clean_d[s:e, None] + lane],
                    fold_direct)

    # N-containing windows: enumerate 4^n canonical substitutions
    # (SfxArray.cpp:4152-4177); each variant is one query, minima fold
    # back to the source position
    if len(some_n):
        var_pos = []
        var_reads = []
        for p0 in some_n:
            win = np.array(g.seq[p0:p0 + K])
            nidx = np.nonzero(win >= 4)[0]
            n = len(nidx)
            for it in range(4 ** n):
                v = win.copy()
                for d, ix in enumerate(nidx):
                    v[ix] = (it >> (2 * d)) & 3
                var_pos.append(p0)
                var_reads.append(v)
        var_pos = np.asarray(var_pos, np.int64)
        var_d = torch.from_numpy(np.stack(var_reads)).to(dev)

        def fold_variant(chunk, best):
            np.minimum.at(out, chunk, best.astype(np.uint16))

        run_batches(np.arange(len(var_pos), dtype=np.int64),
                    lambda s, e: var_d[s:e],
                    lambda c, b: fold_variant(var_pos[c], b))

    # >4 indeterminates: treated as Hamming 0 from anything (reference)
    out[many_n] = 0
    out[max(0, nk):] = BIG
    return out


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


def hmg_fits(lengths, K: int) -> bool:
    """Whether the .hmg of chromosomes of these lengths fits the format,
    whose header holds the file's length in 32 signed bits (tsHHamHdr Len)
    and each chromosome's offset in 32 unsigned bits: GRCh38 at K 25 needs
    6.18 GB and does not."""
    n = _HMG_HDR_LEN + sum(_HMG_CHROM_FIXED + 2 * max(0, int(ln) - K + 1)
                           for ln in lengths)
    return n < 1 << 31


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
