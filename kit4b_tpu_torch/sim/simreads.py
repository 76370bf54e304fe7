"""simreads: simulated readset generator with embedded ground truth, the
port's own copy of kit4b_tpu/sim/simreads.py (tests/test_torch_rehomed.py
holds every mode equal to the original).

Capability parity with the reference CSimReads (libkit4b/SimReads.cpp:1805
GenSimReads, :2229 ThreadSimReads, :272 SimSeqErrors, :137 SimInDels, :174
SimArtefacts, :340 SimSeqRand), using the same ground-truth descriptor
layout so the `benchmark` scorer and the reference's own can read either
output (SimReads.cpp:1655):

    >lcl|NNNNNNNN|chrom|start|end|len|strand|numsubs|indelsize

(`lcr` for random unalignable reads; `end` = start + len - 1 + indelsize,
where indelsize > 0 is a deletion relative to the read and < 0 an
insertion — the SimInDels return convention.)

Per-read pipeline order matches ThreadSimReads (SimReads.cpp:1624-1650):
strand revcomp -> 5'/3' adapter artefacts -> micro-InDel -> sequencer
substitutions (random lcr reads take SimSeqRand instead of the last two).

Error models:
  - 'illumina' / 'static': the reference composite profiles. Per-read
    substitution COUNTS come from the dynamic profile (P(0) = (1-p)^L,
    then successive halving of the remainder — SimReads.cpp:295-312) or
    from the hardcoded Poisson(1) StaticErrProfile (:246-258); POSITIONS
    from the 20-bin IlluminaSpatialDist cumulative table (:268,
    moderate 5' rise, heavy 3' tail) unless uniform_profile (-Z).
  - 'uniform': flat per-base Bernoulli (kept for tests/benches that want
    an exact mean rate).
  - 'fixed': exactly int(subs_rate) substitutions per read (generrmode 1).

Vectorized NumPy with a seeded Generator instead of per-thread CTwister
streams. The draws come in the JAX package's order in every mode, including
the draws a mode makes only when it is on (fragment lengths only for paired
ends, the random-read coin only with rand_reads), so the same SimParams give
the same reads in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io.fasta import Genome, SeqRecord, write_fasta, write_fastq

# default artefact sequences (ngskit4b/SimReads.cpp:42-43):
# Illumina Single End Adapter 1 / Single End Sequencing Primer
DEFAULT_ARTEF5 = "ACACTCTTTCCCTACACGACGCTGTTCCATCT"
DEFAULT_ARTEF3 = "ACACTCTTTCCCTACACGACGCTCTTCCGATCT"

# StaticErrProfile (SimReads.cpp:246-258): Poisson(mean=1) proportions of
# reads with 0..7 substitutions; remainder gets 8
_STATIC_PROFILE = np.array([0.367879, 0.367879, 0.183944, 0.061313,
                            0.015328, 0.003066, 0.000511, 0.000073])

# IlluminaSpatialDist (SimReads.cpp:268): cumulative 20-bin position
# weights over the read length; moderate 5' rise, most errors at 3'
_ILLUMINA_SPATIAL = np.array([40, 55, 64, 72, 80, 88, 96, 104, 112, 121,
                              131, 142, 156, 174, 197, 228, 270, 325,
                              400, 500], dtype=np.int64)


@dataclass
class SimParams:
    n_reads: int = 100_000
    read_len: int = 100
    pe: bool = False
    pe_insert_min: int = 200     # reference -j MinFragLen
    pe_insert_max: int = 500     # reference -J MaxFragLen
    # error model: 'none' | 'uniform' | 'illumina' | 'static' | 'fixed'
    error_mode: str = "none"
    subs_rate: float = 0.01      # mean per-base substitution rate
    uniform_profile: bool = False  # -Z: uniform positions (vs 3'-skewed)
    strand: str = "both"         # 'watson' | 'both'
    seed: int = 1
    # micro-InDels (-x/-X, SimReads.cpp:137 SimInDels)
    indel_rate: float = 0.0      # fraction of reads with one InDel
    indel_size: int = 3          # max size; actual uniform 1..size
    # adapter artefacts (-a/-A/-b, SimReads.cpp:174 SimArtefacts)
    artef5_rate: float = 0.0
    artef3_rate: float = 0.0
    artef5_seqs: tuple = (DEFAULT_ARTEF5,)
    artef3_seqs: tuple = (DEFAULT_ARTEF3,)
    # random unalignable reads (-R, SimSeqRand -> 'lcr' descriptors)
    rand_reads: float = 0.0
    # restrict fragments to these intervals [(chrom, start, end), ...]
    # (-G genomic region / -t featfile restriction)
    regions: list | None = None
    dedupe: bool = False         # -d: unique read sequences only


_ASCII2CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ASCII2CODE[_b] = _i
    _ASCII2CODE[_b + 32] = _i


def _artef_codes(seqs) -> list[np.ndarray]:
    return [_ASCII2CODE[np.frombuffer(str(s).encode(), np.uint8)]
            for s in seqs]


def _count_probs(params: SimParams, L: int) -> np.ndarray:
    """Per-read substitution-count distribution over 0..8 subs."""
    if params.error_mode == "static":
        p = _STATIC_PROFILE.copy()
    else:  # dynamic (SimReads.cpp:295-312): P(0)=(1-p)^L, halve remainder
        p = np.zeros(8)
        cur = (1.0 - params.subs_rate) ** L
        acc = 0.0
        for i in range(8):
            p[i] = cur
            acc += cur
            cur = (1.0 - acc) / 2.0
    probs = np.zeros(9)
    probs[:8] = p
    probs[8] = max(0.0, 1.0 - p.sum())
    return probs / probs.sum()


def _spatial_positions(m: int, L: int, rng: np.random.Generator):
    """Illumina 3'-skewed positions: bin by the cumulative spatial table,
    then uniform within the bin's read-length twentieth."""
    nb = len(_ILLUMINA_SPATIAL)
    u = rng.integers(0, _ILLUMINA_SPATIAL[-1] + 1, m)
    d = np.searchsorted(_ILLUMINA_SPATIAL, u, side="left")
    d = np.minimum(d, nb - 1)
    minp = (d * L) // nb
    maxp = np.where(d == nb - 1, L - 1, minp + L // nb - 1)
    maxp = np.maximum(maxp, minp)
    return rng.integers(minp, maxp + 1)


def _apply_errors(reads: np.ndarray, params: SimParams,
                  rng: np.random.Generator) -> np.ndarray:
    """Substitute bases in-place; returns per-read substitution counts."""
    n, L = reads.shape
    mode = params.error_mode
    if mode == "none" or n == 0:
        return np.zeros(n, dtype=np.int32)
    if mode == "uniform":
        hit = rng.random((n, L)) < params.subs_rate
        hit &= reads < 4
        delta = rng.integers(1, 4, size=(n, L), dtype=np.uint8)
        reads[hit] = (reads[hit] + delta[hit]) % 4
        return hit.sum(axis=1).astype(np.int32)
    if mode == "fixed":
        counts = np.full(n, min(int(params.subs_rate), L), np.int32)
    elif mode in ("illumina", "static"):
        probs = _count_probs(params, L)
        counts = rng.choice(9, size=n, p=probs).astype(np.int32)
    else:
        raise ValueError(f"unknown error mode {mode}")
    # draw `counts[i]` DISTINCT positions per read (reference redraws on
    # collision, SimReads.cpp:352-358), spatially skewed unless -Z
    used = np.zeros((n, L), bool)
    for j in range(int(counts.max()) if n else 0):
        need = np.nonzero(counts > j)[0]
        while len(need):
            if params.uniform_profile:
                p = rng.integers(0, L, len(need))
            else:
                p = _spatial_positions(len(need), L, rng)
            fresh = ~used[need, p]
            used[need[fresh], p[fresh]] = True
            need = need[~fresh]
    # count only positions actually substituted: a drawn position that
    # landed on an N base gets no edit, so it must not inflate numsubs
    applied = used & (reads < 4)
    ridx, pidx = np.nonzero(applied)
    delta = rng.integers(1, 4, len(ridx), dtype=np.uint8)
    reads[ridx, pidx] = (reads[ridx, pidx] + delta) % 4
    return applied.sum(axis=1).astype(np.int32)


def _apply_artefacts(reads: np.ndarray, params: SimParams,
                     rng: np.random.Generator) -> None:
    """5'/3' adapter artefacts in-place (SimReads.cpp:174 SimArtefacts):
    artefact length uniform 1..len(seq); 3' overwrites the read tail with
    the artefact PREFIX; 5' shifts the read right and prepends the
    artefact SUFFIX."""
    n, L = reads.shape
    for is3, rate, seqs in ((False, params.artef5_rate, params.artef5_seqs),
                            (True, params.artef3_rate, params.artef3_seqs)):
        if rate <= 0.0 or not seqs:
            continue
        codes = _artef_codes(seqs)
        hit = np.nonzero(rng.random(n) < rate)[0]
        for i in hit:
            a = codes[rng.integers(0, len(codes))] if len(codes) > 1 \
                else codes[0]
            alen = min(int(rng.integers(1, len(a) + 1)), L)
            if is3:
                reads[i, L - alen:] = a[:alen]
            else:
                reads[i, alen:] = reads[i, :L - alen]
                reads[i, :alen] = a[len(a) - alen:]


def _sample_fragments(genome: Genome, params: SimParams, n: int,
                      frag_len: np.ndarray, rng: np.random.Generator):
    """(ci, start) fragment placements — whole-genome length-proportional,
    or restricted to params.regions intervals."""
    if params.regions:
        name_to_ci = {nm: i for i, nm in enumerate(genome.names)}
        iv = [(name_to_ci[c], int(s), int(e)) for c, s, e in params.regions
              if c in name_to_ci and e - s >= int(frag_len.max())]
        if not iv:
            raise ValueError("no region interval can hold a fragment")
        w = np.array([e - s - int(frag_len.max()) + 1 for _, s, e in iv],
                     dtype=np.float64)
        pick = rng.choice(len(iv), size=n, p=w / w.sum())
        ci = np.array([iv[k][0] for k in pick])
        lo = np.array([iv[k][1] for k in pick])
        hi = np.array([iv[k][2] for k in pick])
        start = lo + (rng.random(n) * (hi - lo - frag_len + 1)).astype(
            np.int64)
        return ci, start
    probs = genome.lengths / genome.lengths.sum()
    ci = rng.choice(len(genome.names), size=n, p=probs)
    max_start = genome.lengths[ci] - frag_len
    ok = max_start >= 0
    if not ok.all():
        ci, max_start = ci[ok], max_start[ok]
        frag_len[: len(ci)] = frag_len[ok]
    start = (rng.random(len(ci)) * (max_start + 1)).astype(np.int64)
    return ci, start


def _extract_raw(genome: Genome, gstart, m_start, L_ext: int):
    idx = (gstart + m_start)[:, None] + np.arange(L_ext)[None, :]
    return genome.seq[np.minimum(idx, len(genome.seq) - 1)].copy()


def _finish_mate(m_raw: np.ndarray, rev_rows: np.ndarray,
                 params: SimParams, rng: np.random.Generator,
                 is_rand: np.ndarray):
    """Build final reads from raw (un-revcomped) genome windows
    [n, L + headroom]: per-read InDel (exact genomic span, then strand
    revcomp), adapter artefacts, sequencer errors. Returns (reads [n, L],
    subs [n], indel [n]); indel > 0 deletion, < 0 insertion (the
    SimInDels return convention, so end = start + L - 1 + indel holds on
    BOTH strands).

    Stage order note: the reference applies artefacts before InDels
    (ThreadSimReads, SimReads.cpp:1624-1650); here the InDel is folded
    into window extraction (exact-span revcomp needs the size first), so
    artefacts land after it — the two only compose differently on reads
    carrying both corruptions, and neither is truth-tracked."""
    n = m_raw.shape[0]
    L = params.read_len
    # strand-aware base reads (no indel): '+' first L, '-' revcomp(first L)
    reads = np.ascontiguousarray(m_raw[:, :L])
    reads[rev_rows] = dna._COMPLEMENT[reads[rev_rows]][:, ::-1]
    indel = np.zeros(n, np.int32)
    if params.indel_rate > 0.0 and params.indel_size > 0 and n:
        hit = np.nonzero((rng.random(n) < params.indel_rate)
                         & ~is_rand)[0]
        for i in hit:
            s = int(rng.integers(1, params.indel_size + 1))
            insert = bool(rng.integers(0, 2))
            span = L - s if insert else L + s
            w = m_raw[i, :span]
            if rev_rows[i]:
                w = dna._COMPLEMENT[w][::-1]
            p = int(rng.integers(0, L - s + 1))
            if insert:
                ins = rng.integers(0, 4, s).astype(np.uint8)
                reads[i] = np.concatenate([w[:p], ins, w[p:]])
                indel[i] = -s
            else:
                reads[i] = np.concatenate([w[:p], w[p + s:]])
                indel[i] = s
    _apply_artefacts(reads, params, rng)
    subs = np.zeros(n, np.int32)
    norm = ~is_rand
    if norm.any():
        sub_part = reads[norm]
        subs_n = _apply_errors(sub_part, params, rng)
        reads[norm] = sub_part
        subs[norm] = subs_n
    if is_rand.any():
        # SimSeqRand (SimReads.cpp:340): every base replaced by a
        # different random base -> effectively unalignable
        rr = np.nonzero(is_rand)[0]
        delta = rng.integers(1, 4, (len(rr), L), dtype=np.uint8)
        reads[rr] = (reads[rr] + delta) % 4
        subs[rr] = L
    return reads, subs, indel


def sim_reads(genome: Genome, params: SimParams,
              start_id: int = 1):
    """Generate SE reads (or mate-1 list + mate-2 list when pe=True)."""
    rng = np.random.default_rng(params.seed)
    L = params.read_len
    ext = params.indel_size if params.indel_rate > 0 else 0

    def gen(n_want, sid):
        frag_len = (rng.integers(params.pe_insert_min,
                                 params.pe_insert_max + 1, n_want)
                    if params.pe else np.full(n_want, L))
        frag_len = np.maximum(frag_len, L) + ext
        ci, start = _sample_fragments(genome, params, n_want, frag_len, rng)
        n = len(ci)
        frag_len = frag_len[:n]
        if params.strand == "both":
            strand = rng.integers(0, 2, n).astype(np.int8)
        else:
            strand = np.zeros(n, dtype=np.int8)
        is_rand = (rng.random(n) < params.rand_reads) if params.rand_reads \
            else np.zeros(n, bool)
        gstart = genome.starts[ci]

        m1_start = np.where(strand == 0, start, start + frag_len - ext - L)
        m1_raw = _extract_raw(genome, gstart, m1_start, L + ext)
        m1, subs1, ind1 = _finish_mate(m1_raw, strand == 1, params, rng,
                                       is_rand)
        recs1 = []
        for i in range(n):
            tag = "lcr" if is_rand[i] else "lcl"
            name = (f"{tag}|{sid + i:08d}|{genome.names[ci[i]]}|"
                    f"{int(m1_start[i])}|"
                    f"{int(m1_start[i]) + L - 1 + int(ind1[i])}|{L}|"
                    f"{'-' if strand[i] else '+'}|{int(subs1[i])}|"
                    f"{int(ind1[i])}")
            recs1.append(SeqRecord(name, "", m1[i]))
        if not params.pe:
            return recs1, None
        m2_strand = 1 - strand
        m2_start = np.where(m2_strand == 0, start,
                            start + frag_len - ext - L)
        m2_raw = _extract_raw(genome, gstart, m2_start, L + ext)
        m2, subs2, ind2 = _finish_mate(m2_raw, m2_strand == 1, params, rng,
                                       is_rand)
        recs2 = []
        for i in range(n):
            tag = "lcr" if is_rand[i] else "lcl"
            name = (f"{tag}|{sid + i:08d}|{genome.names[ci[i]]}|"
                    f"{int(m2_start[i])}|"
                    f"{int(m2_start[i]) + L - 1 + int(ind2[i])}|{L}|"
                    f"{'-' if m2_strand[i] else '+'}|{int(subs2[i])}|"
                    f"{int(ind2[i])}")
            recs2.append(SeqRecord(name, "", m2[i]))
        return recs1, recs2

    recs1, recs2 = gen(params.n_reads, start_id)
    if params.dedupe:
        # -d: unique read sequences only; regenerate to reach n (reference
        # dedupes against all previously generated reads)
        seen = set()
        u1, u2 = [], []
        sid = start_id
        tries = 0
        while len(u1) < params.n_reads and tries < 20:
            for i, r in enumerate(recs1):
                key = r.codes.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                u1.append(r)
                if recs2 is not None:
                    u2.append(recs2[i])
                if len(u1) >= params.n_reads:
                    break
            if len(u1) < params.n_reads:
                sid += params.n_reads
                recs1, recs2 = gen(params.n_reads - len(u1), sid)
                tries += 1
            else:
                break
        recs1 = u1
        recs2 = u2 if recs2 is not None else None
    if recs2 is None:
        return recs1
    return recs1, recs2


def simulate_snps(genome: Genome, rate: float = 0.001, seed: int = 1):
    """Plant SNPs into a copy of the genome (reference CSimReads::SimulateSNPs,
    libkit4b/SimReads.cpp:1222): each base mutated with probability `rate` to
    one of the three other bases. Returns (mutated Genome, truth list of
    (chrom, loci, ref_base, alt_base))."""
    rng = np.random.default_rng(seed)
    seq = genome.seq.copy()
    can = seq < 4
    hit = (rng.random(len(seq)) < rate) & can
    idx = np.nonzero(hit)[0]
    delta = rng.integers(1, 4, len(idx), dtype=np.uint8)
    alts = (seq[idx] + delta) % 4
    truth = []
    ci, off = genome.locate(idx)
    for j, i in enumerate(idx):
        truth.append((genome.names[int(ci[j])], int(off[j]),
                      int(seq[i]), int(alts[j])))
    seq[idx] = alts
    g2 = Genome(list(genome.names), genome.starts.copy(),
                genome.lengths.copy(), seq)
    return g2, truth


def write_snp_bed(path, truth) -> None:
    """Truth SNP loci as BED (-u outsnp, SimReads.cpp:1222 flow)."""
    bases = "ACGTN"
    with open(path, "w") as f:
        for chrom, loci, ref, alt in truth:
            f.write(f"{chrom}\t{loci}\t{loci + 1}\t"
                    f"{bases[ref]}>{bases[alt]}\t0\t+\n")


def parse_truth(qname: str):
    """Parse a simreads ground-truth read name -> dict (or None)."""
    parts = qname.split("|")
    if len(parts) != 9 or parts[0] not in ("lcl", "lcr"):
        return None
    return {
        "random": parts[0] == "lcr",
        "read_id": int(parts[1]),
        "chrom": parts[2],
        "start": int(parts[3]),
        "end": int(parts[4]),
        "len": int(parts[5]),
        "strand": parts[6],
        "subs": int(parts[7]),
        "indel": int(parts[8]),
    }


def write_reads(path, records, fmt: str = "fasta") -> None:
    if fmt == "fasta":
        write_fasta(path, records)
    else:
        write_fastq(path, records)
