"""Alignment-free K-mer markers (kmarkers / prekmarkers / pseudogenome), on
PyTorch.

Port of kit4b_tpu/kmer/kmarkers.py. The host code (`build_pseudogenome`,
`write_pseudogenome_bed`, `Marker`, `write_markers_fasta` and the
prekmarkers walk over the suffix array) is numpy, copied as it is; the
kmarkers device pass is `kmarkers_pass`, plain PyTorch on the caller's
device (CUDA by default), bit-identical to the JAX pass on the same inputs
(tests/test_torch_kmarkers.py).

Reference parity:
  - pseudogenome (ngskit4b/genpseudogenome.cpp:61 GPGProcess): concatenate
    per-cultivar fastas into one pseudo-genome + BED of source coords. Here a
    Genome carries a cultivar id per chromosome instead of textual BED
    gymnastics, with the BED still emitted for interop.
  - kmarkers (CLocKMers, ngskit4b/LocKMers.cpp:525 LocKMers, :1105
    MatchesOtherChroms usage): K-mers present uniquely in the target cultivar
    and at Hamming distance >= MinHamming from every K-mer of every other
    cultivar. The reference's pigeonhole suffix-array probe
    (CSfxArray::MatchesOtherChroms(MinHamming-1)) maps directly onto the
    batched seed-and-extend pass: target K-mers are queried like reads with
    pigeonhole cores, and any other-cultivar hit with mm < MinHamming
    disqualifies. Consecutive accepted positions extend into maximal marker
    sequences (the reference's marker extension option).
  - prekmarkers (CMarkerKMers, ngskit4b/MarkerKMers.cpp:277 LocKMers →
    CSfxArray::GenKMerCultsCnts SfxArray.cpp:2805): walk the suffix array
    counting per-cultivar occurrences of each distinct K-mer prefix; report
    K-mers present in >= min_cultivars (sense counts; antisense via revcomp
    lookup).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import dna
from ..device import resolve
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome, SeqRecord
from ..ops import seed_extend_fast as F
from ..ops.extend_packed import pack_genome

INT32_MAX = int(np.iinfo(np.int32).max)
# escalation tiers (batch, n_compact, max_ml) for positions whose hit
# capacity saturated; the last tier's survivors are dropped
TIERS = ((4096, 256, 128), (1024, 2048, 512))
IN_FLIGHT = 4      # tier batches queued on the device before the oldest drains


# --- pseudogenome -----------------------------------------------------------

def build_pseudogenome(cultivar_fastas: dict[str, list],
                       ) -> tuple[Genome, np.ndarray, list[str]]:
    """cultivar name -> list of fasta paths. Returns (genome,
    chrom_cultivar_idx, cultivar_names): standard concatenated Genome whose
    chromosomes carry their source cultivar index."""
    from ..io.fasta import read_seqs
    names: list[str] = []
    starts: list[int] = []
    lengths: list[int] = []
    chunks: list[np.ndarray] = []
    chrom_cult: list[int] = []
    cultivars = list(cultivar_fastas)
    pos = 0
    for ci, cult in enumerate(cultivars):
        for path in cultivar_fastas[cult]:
            for rec in read_seqs(path):
                names.append(f"{cult}.{rec.name}")
                starts.append(pos)
                lengths.append(len(rec.codes))
                chunks.append(rec.codes)
                chunks.append(np.array([dna.BASE_EOS], np.uint8))
                chrom_cult.append(ci)
                pos += len(rec.codes) + 1
    seq = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    if len(seq):
        seq[-1] = dna.BASE_EOG
    g = Genome(names, np.asarray(starts, np.int64),
               np.asarray(lengths, np.int64), seq)
    return g, np.asarray(chrom_cult, np.int32), cultivars


def write_pseudogenome_bed(path, genome: Genome, chrom_cult, cultivars):
    """BED of pseudo-chrom coords (genpseudogenome's gene BED output)."""
    with open(path, "w") as f:
        for i, name in enumerate(genome.names):
            f.write(f"{name}\t0\t{int(genome.lengths[i])}\t"
                    f"{cultivars[int(chrom_cult[i])]}\t0\t+\n")


# --- kmarkers ---------------------------------------------------------------

@dataclass
class Marker:
    chrom: str
    start: int           # 0-based within chrom
    length: int          # marker sequence length (>= kmer_len when extended)
    seq: np.ndarray


def _fast_device_arrays(index: SfxIndex, read_len: int,
                        device: torch.device):
    """(gview, sa, lut) tensors on `device` for the fast row-gather pass:
    gview holds the same rows as the JAX package's host `make_gview`, in
    the int64 word carrier of `ops.bits`."""
    nw2 = (read_len + 15) // 16 + 1
    gpack, gbad = pack_genome(index.genome.seq, nw2 + 1)
    gview = F.make_gview_device(gpack, gbad, nw2, device)
    sa = torch.from_numpy(index.sa_clean.astype(np.int32)).to(device)
    lut = torch.from_numpy(index.lut.astype(
        np.int32 if index.lut[-1] < 2**31 else np.int64)).to(device)
    return gview, sa, lut


def core_offsets(kmer_len: int, min_hamming: int, lut_k: int) -> tuple:
    """Pigeonhole cores: to guarantee finding every hit with
    mm <= min_hamming - 1, min_hamming equal slices of the K-mer, each
    seed start kept where a lut_k seed fits."""
    ncores = max(1, min_hamming)
    cl = kmer_len // ncores
    return tuple(min(j * cl, kmer_len - lut_k) for j in range(ncores))


def kmarkers_pass(gview, sa, lut, genome_u8, starts_d, cult_d, qp, *,
                  K: int, genome_len: int, offsets: tuple, lut_k: int,
                  n_compact: int, max_ml: int, min_hamming: int,
                  target: int) -> torch.Tensor:
    """One kmarkers batch on the device of its tensors: the K-mer windows
    at positions `qp` gather from the resident genome, acceptance
    classifies on the device, and ONE int8 code per position comes back
    (0 reject / 1 accept / 2 saturated). Nothing in it waits for the
    device, so batches queue behind each other."""
    dev = qp.device
    qpc = qp.to(torch.int32).clamp(0, genome_len - K)
    reads = genome_u8[qpc[:, None].long()
                      + torch.arange(K, device=dev)[None, :]]
    ids, mm, ovf = F.fast_candidates(
        gview, sa, lut, reads, genome_len=genome_len, offsets=offsets,
        lut_k=lut_k, n_compact=n_compact)
    out = F.finalize_fast(ids, mm, max_ml=max_ml)
    hid = out["hit_id"]
    hmm = out["hit_mm"]
    valid = hid != INT32_MAX
    hpos = torch.where(valid, hid >> 1, 0)
    ci = torch.searchsorted(starts_d, hpos, right=True) - 1
    cult = cult_d[ci.clamp(0, cult_d.shape[0] - 1)]
    disq = (valid & (hmm < min_hamming) & (cult != target)).any(1)
    self_exact = valid & (hmm == 0) & (cult == target)
    self_pos = torch.where(self_exact, hpos, INT32_MAX)
    min_self = self_pos.amin(1)
    sat = ovf | (valid.sum(1) >= max_ml)
    ok = ~sat & ~disq & self_exact.any(1) & (min_self == qpc)
    return ok.to(torch.int8) + 2 * sat.to(torch.int8)


def find_cultivar_markers(index: SfxIndex, chrom_cult: np.ndarray,
                          target_cultivar: int, *,
                          kmer_len: int = 50, min_hamming: int = 2,
                          batch: int = 49152, extend: bool = True,
                          max_ml: int = 48,
                          device: str | torch.device = "cuda",
                          stats: dict | None = None) -> list[Marker]:
    """K-mers present in `target_cultivar` (and ONLY there exactly) with
    Hamming >= min_hamming from every K-mer of all other cultivars (both
    strands): the accepted positions of `marker_positions`, with runs of
    consecutive positions extended into maximal markers when `extend`."""
    acc = marker_positions(index, chrom_cult, target_cultivar,
                           kmer_len=kmer_len, min_hamming=min_hamming,
                           batch=batch, max_ml=max_ml, device=device,
                           stats=stats)
    return extend_markers(index.genome, acc, kmer_len, extend)


def marker_positions(index: SfxIndex, chrom_cult: np.ndarray,
                     target_cultivar: int, *, kmer_len: int = 50,
                     min_hamming: int = 2, batch: int = 49152,
                     max_ml: int = 48, device: str | torch.device = "cuda",
                     stats: dict | None = None) -> np.ndarray:
    """Sorted concatenated positions of the target's accepted K-mers.

    Acceptance mirrors CLocKMers (ngskit4b/LocKMers.cpp:1094-1165):
      - reject on any exact other-cultivar occurrence of the K-mer or its
        revcomp (bNonTargHit);
      - reject when a K-mer of another cultivar lies within
        Hamming < min_hamming (the documented MatchesOtherChroms
        contract; the reference implementation's mismatch-counting loop is
        dead code, SfxArray.cpp:5223, and tests/test_golden_kmarkers.py
        arbitrates this with the reference binary);
      - K-mers repeated WITHIN the target are accepted once, at their
        first-encountered locus (the reference's SetBaseFlags dup skip,
        LocKMers.cpp:1110-1121) — implemented as accept-at-minimal exact
        self-locus over both orientations.

    Each target position is one row of `kmarkers_pass`, IN_FLIGHT batches
    queued on `device`. Positions whose hit capacity saturated escalate
    through the TIERS so crowding can never hide a disqualifying hit; the
    last tier's survivors sit in >512-copy repeat families and are
    dropped. The answer depends only on the set of hits of each position,
    not on the order of a bucket, so any index of the genome will do
    (`SfxIndex.build` or `build_buckets`).

    `stats`, when given, receives the positions run in each tier ("tier1",
    "tier2", "tier3") and the last tier's survivors ("dropped")."""
    dev = resolve(device)
    g = index.genome
    G = len(g.seq)
    if 2 * G + 1 >= 2 ** 31:
        raise ValueError(
            f"kmarkers on a genome of {G} bases: hit ids 2*G+1 overflow "
            "int32; genomes past 2^30 bases need the per-shard offsets "
            "of ROADMAP.md queue A item 18")
    K = kmer_len
    gview_d, sa_d, lut_d = _fast_device_arrays(index, K, dev)
    genome_d = torch.from_numpy(g.seq).to(dev)
    starts_d = torch.from_numpy(g.starts.astype(np.int32)).to(dev)
    cult_d = torch.from_numpy(np.asarray(chrom_cult, np.int32)).to(dev)
    kw = dict(K=K, genome_len=G,
              offsets=core_offsets(K, min_hamming, index.lut_k),
              lut_k=index.lut_k,
              min_hamming=min_hamming, target=int(target_cultivar))

    accepted: list[int] = []
    escalate: list[int] = []
    counts = {"tier1": 0, "tier2": 0, "tier3": 0, "dropped": 0}

    def run(batches, n_compact, ml):
        """Runs (host positions, device qp) batches, IN_FLIGHT queued; each
        drain's .cpu() waits for its own batch only."""
        pending = deque()

        def drain(chunk, codes):
            code = codes.cpu().numpy()[:len(chunk)]
            accepted.extend(chunk[code == 1].tolist())
            escalate.extend(chunk[code >= 2].tolist())
        for chunk, qp in batches:
            pending.append((chunk, kmarkers_pass(
                gview_d, sa_d, lut_d, genome_d, starts_d, cult_d, qp,
                n_compact=n_compact, max_ml=ml, **kw)))
            if len(pending) >= IN_FLIGHT:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())

    def tier1_batches(cstart, n):
        # positions made on the device: nothing is copied in per batch;
        # the last batch is padded with the chromosome's first position
        lane = torch.arange(batch, dtype=torch.int32, device=dev)
        for s in range(0, n, batch):
            nb = min(batch, n - s)
            chunk = np.arange(cstart + s, cstart + s + nb, dtype=np.int64)
            yield chunk, torch.where(lane < nb, lane + (cstart + s), cstart)

    for ci in np.nonzero(chrom_cult == target_cultivar)[0]:
        cstart = int(g.starts[ci])
        clen = int(g.lengths[ci])
        if clen < K:
            continue
        counts["tier1"] += clen - K + 1
        run(tier1_batches(cstart, clen - K + 1), 24, max_ml)

    # saturated positions re-run at capacities where crowding by exact
    # self-hits cannot hide a disqualifying other-cultivar hit
    for tier, (EB, ENC, EML) in enumerate(TIERS, start=2):
        if not escalate:
            break
        esc = np.asarray(escalate, np.int64)
        escalate = []
        counts[f"tier{tier}"] = len(esc)
        esc_d = torch.from_numpy(esc.astype(np.int32)).to(dev)   # one copy

        def tier_batches():
            for s in range(0, len(esc), EB):
                qp = esc_d[s:s + EB]
                if len(qp) < EB:       # padded with the tier's first position
                    qp = torch.cat([qp, esc_d[:1].expand(EB - len(qp))])
                yield esc[s:s + EB], qp
        run(tier_batches(), ENC, EML)
    counts["dropped"] = len(escalate)
    if stats is not None:
        stats.update(counts)
    return np.asarray(sorted(accepted), np.int64)


def extend_markers(g: Genome, acc: np.ndarray, K: int,
                   extend: bool) -> list[Marker]:
    """Markers of sorted accepted positions: one a position, or with
    `extend` one a run of consecutive positions, as long as the run."""
    markers: list[Marker] = []
    if not len(acc):
        return markers
    run_start = acc[0]
    prev = acc[0]

    def emit(a, b):
        ci = int(np.searchsorted(g.starts, a, side="right") - 1)
        off = int(a - g.starts[ci])
        length = int(b - a) + K
        markers.append(Marker(g.names[ci], off, length,
                              g.seq[a:a + length].copy()))
    for p in acc[1:]:
        if extend and p == prev + 1:
            prev = p
            continue
        emit(run_start, prev)
        run_start = prev = p
    emit(run_start, prev)
    return markers


def write_markers_fasta(path, markers: list[Marker],
                        prefix: str = "Marker") -> None:
    from ..io.fasta import write_fasta
    recs = [SeqRecord(f"{prefix}{i+1}",
                      f"{m.chrom}|{m.start}|{m.length}", m.seq)
            for i, m in enumerate(markers)]
    write_fasta(path, recs)


# --- prekmarkers ------------------------------------------------------------

def prefix_kmer_counts(index: SfxIndex, chrom_cult: np.ndarray,
                       n_cultivars: int, *, kmer_len: int = 25,
                       block: int = 1 << 18):
    """Per-distinct-K-mer per-cultivar sense occurrence counts via one pass
    over the (already sorted) clean suffix array.

    Returns (rep_pos, counts): rep_pos int64 [n_distinct] — representative
    suffix position of each distinct K-mer; counts int32 [n_distinct,
    n_cultivars].
    """
    g = index.genome
    sa = index.sa_clean.astype(np.int64)
    M = len(sa)
    if M == 0:
        return np.zeros(0, np.int64), np.zeros((0, n_cultivars), np.int32)
    K = kmer_len
    pos_cult = np.repeat(chrom_cult, (g.lengths + 1).astype(np.int64))

    # valid suffixes: K clean bases (first lut_k guaranteed; verify rest)
    # boundary[i] = True when suffix sa[i] starts a new distinct K-mer
    boundary = np.zeros(M, bool)
    boundary[0] = True
    valid = np.ones(M, bool)
    for s in range(0, M, block):
        e = min(M, s + block)
        idx = sa[s:e, None] + np.arange(K)[None, :]
        w = g.seq[np.minimum(idx, len(g.seq) - 1)]
        valid[s:e] = (w < 4).all(axis=1) & (sa[s:e] + K <= len(g.seq))
        wp = np.vstack([g.seq[np.minimum(sa[s - 1] + np.arange(K),
                                         len(g.seq) - 1)][None, :]
                        if s else w[:1], w[:-1]])
        boundary[s:e] = (w != wp).any(axis=1)
    boundary[0] = True
    boundary &= valid
    # drop invalid suffixes entirely
    vidx = np.nonzero(valid)[0]
    vb = boundary[vidx].copy()
    vb[0] = True
    # re-detect boundaries across removed invalid runs
    group = np.cumsum(vb) - 1
    n_groups = int(group[-1]) + 1 if len(group) else 0
    rep_pos = sa[vidx[np.nonzero(vb)[0]]]
    cult = pos_cult[sa[vidx]]
    counts = np.zeros((n_groups, n_cultivars), np.int32)
    np.add.at(counts, (group, cult), 1)
    return rep_pos, counts


def antisense_counts(index: SfxIndex, rep_pos: np.ndarray,
                     counts: np.ndarray, kmer_len: int) -> np.ndarray:
    """Per-cultivar ANTISENSE counts for each distinct K-mer: occurrences
    of revcomp(kmer) on the sense strand (CSfxArray::GenKMerCultsCnts
    counts both orientations, SfxArray.cpp:2805). K-mers pack into 2-bit
    int64 keys (K <= 31), matched by sort + searchsorted."""
    K = kmer_len
    if K > 31:
        raise ValueError("antisense counts support K <= 31 (2-bit packing)")
    g = index.genome
    if len(rep_pos) == 0:
        return np.zeros_like(counts)
    w = g.seq[rep_pos[:, None] + np.arange(K)[None, :]].astype(np.int64)
    pw = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)
    keys = w @ pw
    rc = 3 - w[:, ::-1]
    rc_keys = rc @ pw
    order = np.argsort(keys)
    sk = keys[order]
    j = np.searchsorted(sk, rc_keys)
    j_cl = np.minimum(j, len(sk) - 1)
    hit = sk[j_cl] == rc_keys
    anti = np.zeros_like(counts)
    anti[hit] = counts[order[j_cl[hit]]]
    return anti


def shared_prefix_suffix_markers(index: SfxIndex, chrom_cult: np.ndarray,
                                 n_cultivars: int, *, prefix_len: int,
                                 suffix_len: int, min_cultivars: int = 2,
                                 max_homozygotic: int = 1,
                                 antisense: bool = True):
    """prekmarkers homozygotic-constraint mode (-S maxhomozygotic,
    CSfxArray::GenKMerCultsCnts, libkit4b/SfxArray.cpp:2902-2986): report
    prefixes (prefix_len bases, shared by >= min_cultivars) whose
    (prefix + suffix_len)-length K-mer VARIANTS are each carried by at
    most max_homozygotic cultivars — i.e. the suffix region discriminates
    the cultivars. Counts include antisense occurrences.

    Semantics note: this implements the documented per-variant contract
    ("only report prefixes if K-Mer suffixes are homozygotic between a
    maximum of this many cultivars", MarkerKMers.h:91). The reference
    CODE accumulates its CultivarsHomozygotic flags across suffix
    variants without resetting (SfxArray.cpp:2904-2986), which collapses
    the check into "prefix occurs in <= max cultivars at all" and
    contradicts the reported prefix being SHARED by >= MinCultivars; we
    do not replicate that accumulator bug.

    Returns list of (prefix_codes, per-cultivar presence counts)."""
    P, S = prefix_len, suffix_len
    if P > 31:
        raise ValueError("prefix packing supports prefix_len <= 31")
    full = P + S
    rep_pos, counts = prefix_kmer_counts(index, chrom_cult, n_cultivars,
                                         kmer_len=full)
    if len(rep_pos) == 0:
        return []
    if antisense:
        counts = counts + antisense_counts(index, rep_pos, counts, full)
    g = index.genome
    w = g.seq[rep_pos[:, None] + np.arange(P)[None, :]].astype(np.int64)
    pw = 4 ** np.arange(P - 1, -1, -1, dtype=np.int64)
    pkeys = w @ pw
    order = np.argsort(pkeys, kind="stable")
    sk = pkeys[order]
    newp = np.ones(len(sk), bool)
    newp[1:] = sk[1:] != sk[:-1]
    group = np.cumsum(newp) - 1
    n_groups = int(group[-1]) + 1
    present = (counts[order] > 0)
    # prefix-level cultivar presence = union over variants
    pref_pres = np.zeros((n_groups, n_cultivars), bool)
    np.logical_or.at(pref_pres, group, present)
    # homozygotic metric = max over variants of #cultivars sharing the
    # identical full K-mer
    var_ncult = present.sum(axis=1)
    homo = np.zeros(n_groups, np.int64)
    np.maximum.at(homo, group, var_ncult)
    ok = pref_pres.sum(axis=1) >= min_cultivars
    if max_homozygotic:
        ok &= homo <= max_homozygotic
    out = []
    first_of_group = np.nonzero(newp)[0]
    for gi in np.nonzero(ok)[0]:
        p = int(rep_pos[order[first_of_group[gi]]])
        out.append((g.seq[p:p + P].copy(),
                    pref_pres[gi].astype(np.int32)))
    return out


def shared_prefix_markers(index: SfxIndex, chrom_cult: np.ndarray,
                          n_cultivars: int, *, kmer_len: int = 25,
                          min_cultivars: int = 2,
                          max_per_cultivar: int = 0,
                          antisense: bool = True):
    """prekmarkers report: distinct K-mers present in >= min_cultivars
    (optionally at most max_per_cultivar copies each — homozygotic
    constraint). Counts include antisense occurrences when antisense=True.
    Returns list of (kmer_codes, per-cultivar counts)."""
    rep_pos, counts = prefix_kmer_counts(index, chrom_cult, n_cultivars,
                                         kmer_len=kmer_len)
    if antisense and len(rep_pos):
        counts = counts + antisense_counts(index, rep_pos, counts, kmer_len)
    present = counts > 0
    n_present = present.sum(axis=1)
    ok = n_present >= min_cultivars
    if max_per_cultivar:
        ok &= (counts <= max_per_cultivar).all(axis=1)
    out = []
    g = index.genome
    for i in np.nonzero(ok)[0]:
        p = int(rep_pos[i])
        out.append((g.seq[p:p + kmer_len].copy(), counts[i].copy()))
    return out
