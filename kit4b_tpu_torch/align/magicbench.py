"""MAGIC benchmark: observed-CIGAR error-profile read regeneration and
base-level ground-truth scoring; the port's copy of
kit4b_tpu/align/magicbench.py (host numpy, the same RNG stream).

CBenchmark parity (ngskit4b/Benchmarker.cpp, Benchmarker.h:21-26 modes):

- mode 1 `gen_obs_cigars`: from alignments of real reads, derive observed
  error-profile CIGARs — the aligner's CIGAR refined into '='/'X' runs by
  comparing read bases against the target (Benchmarker.cpp:1390-1590),
  keeping I/D/N ops; written as the reference's CSV
  ("ID","SeqLen","Strand","CIGAR","Error Profile" — Benchmarker.cpp:1236).
- mode 2 `sim_reads_from_profiles`: regenerate reads at random
  length-proportional genome loci, replaying each error profile: '='/'M'
  copy target, 'X'/'S'/'H' copy-then-permute ((b+2)&3,
  Benchmarker.cpp:1911-1922), 'I' permuted without consuming target,
  'D'/'N' skip target. Descriptors carry ground truth
  (">SR<id> <pe> <len> <chrom> <start1> <strand> <cigar> <profid>",
  Benchmarker.cpp:2124).
- mode 3 `score_alignments`: base-level scoring of any aligner's SAM
  against the ground truth: per-base claimed ref loci vs ground-truth ref
  loci (ActualMatchBases), Fbeta measures for bases and reads
  (Benchmarker.cpp:2766-2790).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .. import dna

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")

CONSUME_Q = set("MIS=X")
CONSUME_R = set("MDN=X")


def parse_cigar(s: str) -> list[tuple]:
    return [(int(n), op) for n, op in _CIG_RE.findall(s)]


def cigar_str(ops: list[tuple]) -> str:
    return "".join(f"{n}{op}" for n, op in ops)


def read_len_of(ops: list[tuple]) -> int:
    return sum(n for n, op in ops if op in CONSUME_Q)


def ref_len_of(ops: list[tuple]) -> int:
    return sum(n for n, op in ops if op in CONSUME_R)


def potential_match_bases(ops: list[tuple],
                          sh_as_match: bool = False) -> int:
    """Bases of the read that could align to the target (M/=/X, plus
    S/H when the control aligner soft/hard clips are scored as matches —
    Benchmarker.cpp PotentialMatchBases)."""
    want = set("M=X") | (set("SH") if sh_as_match else set())
    return sum(n for n, op in ops if op in want)


def expand_ref_loci(ops: list[tuple], start: int, read_len: int
                    ) -> np.ndarray:
    """Per-read-base target loci; -1 for bases not consuming reference
    (I/S). H ops consume neither and are skipped."""
    loci = np.full(read_len, -1, np.int64)
    q = 0
    r = start
    for n, op in ops:
        if op in "M=X":
            loci[q:q + n] = np.arange(r, r + n)
            q += n
            r += n
        elif op in "IS":
            q += n
        elif op in "DN":
            r += n
    return loci


# ------------------------------------------------------------- mode 1

@dataclass
class ObsProfile:
    pid: int
    read_len: int
    strand: str                 # '+' or '-'
    cigar: str                  # aligner CIGAR (S converted to M)
    err_profile: str            # '='/'X'/I/D/N refined profile
    insert_size: int = 0        # PE only
    strand2: str = "+"
    cigar2: str = ""
    err_profile2: str = ""


def _refine_profile(ops: list[tuple], read: np.ndarray, target: np.ndarray,
                    tstart: int) -> list[tuple] | None:
    """Split M runs into '='/'X' runs by read-vs-target comparison
    (Benchmarker.cpp:1540-1570). target is the full chrom codes; tstart
    the alignment start within it."""
    out: list[tuple] = []
    q = 0
    r = tstart
    for n, op in ops:
        if op in "M=X":
            if r + n > len(target) or q + n > len(read):
                return None
            eq = read[q:q + n] == target[r:r + n]
            i = 0
            while i < n:
                j = i
                v = eq[i]
                while j < n and eq[j] == v:
                    j += 1
                out.append((j - i, "=" if v else "X"))
                i = j
            q += n
            r += n
        elif op == "I":
            out.append((n, "I"))
            q += n
        elif op in "DN":
            out.append((n, op))
            r += n
        elif op == "S":
            # edge soft clips were converted to M by the caller
            return None
        elif op == "P":
            out.append((n, "P"))
    # merge adjacent same-op runs
    merged: list[tuple] = []
    for n, op in out:
        if merged and merged[-1][1] == op:
            merged[-1] = (merged[-1][0] + n, op)
        else:
            merged.append((n, op))
    return merged


def gen_obs_cigars(sam_path, genome, *, max_reads: int = 2_000_000,
                   pe: bool = False) -> list[ObsProfile]:
    """Derive observed error-profile CIGARs from a SAM of aligned reads
    (Benchmarker.cpp GenObsCIGARs). Alignments must start/end on a
    match (edge soft clips are folded into matches with the start locus
    adjusted back, Benchmarker.cpp:1478-1489); internal clips and hard
    clips are sloughed. PE mode pairs consecutive PE1/PE2 records by
    qname."""
    from ..io.sam import read_sam
    starts = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    lens = {n: int(l) for n, l in zip(genome.names, genome.lengths)}
    profiles: list[ObsProfile] = []
    pending: dict[str, tuple] = {}
    max_len = 0
    for rec in read_sam(sam_path):
        if len(profiles) >= max_reads:
            break
        if not rec.is_mapped or rec.flag & 0x900:
            continue
        if rec.rname not in starts:
            continue
        ops = parse_cigar(rec.cigar)
        if not ops or any(op == "H" for _, op in ops):
            continue
        pos = rec.pos - 1
        # fold edge soft clips into matches, adjusting the start back
        if ops[0][1] == "S":
            if len(ops) < 2 or ops[1][1] != "M":
                continue
            pos -= ops[0][0]
            if pos < 0:
                continue
            ops[0] = (ops[0][0], "M")
        if len(ops) > 1 and ops[-1][1] == "S":
            if ops[-2][1] != "M":
                continue
            ops[-1] = (ops[-1][0], "M")
        if any(op in "SH" for _, op in ops[1:-1][1:] or []):
            continue
        if ops[0][1] not in "M=" or ops[-1][1] not in "M=":
            continue
        rl = read_len_of(ops)
        if ref_len_of(ops) + pos > lens[rec.rname]:
            continue
        read = dna.encode(rec.seq)
        if len(read) != rl:
            continue
        if rl < max_len:
            continue          # silently trimmed relative to longest seen
        max_len = max(max_len, rl)
        s0 = starts[rec.rname]
        target = genome.seq[s0:s0 + lens[rec.rname]]
        prof = _refine_profile(ops, read, target, pos)
        if prof is None:
            continue
        strand = "-" if rec.is_reverse else "+"
        if not pe:
            profiles.append(ObsProfile(len(profiles) + 1, rl, strand,
                                       cigar_str(ops), cigar_str(prof)))
            continue
        mate = pending.pop(rec.qname, None)
        this = (rec, ops, prof, strand)
        if mate is None:
            pending[rec.qname] = this
            continue
        r1, o1, p1, s1 = mate if mate[0].flag & 0x40 else this
        r2, o2, p2, s2 = this if mate[0].flag & 0x40 else mate
        insert = abs(r1.tlen) or abs((r2.pos - 1) - (r1.pos - 1)) + \
            read_len_of(o2)
        profiles.append(ObsProfile(
            len(profiles) + 1, read_len_of(o1), s1, cigar_str(o1),
            cigar_str(p1), insert, s2, cigar_str(o2), cigar_str(p2)))
    return profiles


def write_obs_cigars(path, profiles: list[ObsProfile],
                     pe: bool = False) -> None:
    with open(path, "w") as f:
        if pe:
            f.write('"ID","SeqLen","PE1 Strand","PE1 CIGAR",'
                    '"PE1 Error Profile","PE Insert Size","PE2 Strand",'
                    '"PE2 CIGAR","PE2 Error Profile"\n')
            for p in profiles:
                f.write(f'{p.pid},{p.read_len},{p.strand},{p.cigar},'
                        f'{p.err_profile},{p.insert_size},{p.strand2},'
                        f'{p.cigar2},{p.err_profile2}\n')
        else:
            f.write('"ID","SeqLen","Strand","CIGAR","Error Profile"\n')
            for p in profiles:
                f.write(f'{p.pid},{p.read_len},{p.strand},{p.cigar},'
                        f'{p.err_profile}\n')


def read_obs_cigars(path) -> tuple[list[ObsProfile], bool]:
    import csv as _csv
    profiles = []
    pe = False
    with open(path, newline="") as f:
        for row in _csv.reader(f):
            if not row or not row[0].strip().isdigit():
                pe = len(row) > 5
                continue
            if len(row) >= 9:
                pe = True
                profiles.append(ObsProfile(
                    int(row[0]), int(row[1]), row[2], row[3], row[4],
                    int(row[5]), row[6], row[7], row[8]))
            else:
                profiles.append(ObsProfile(
                    int(row[0]), int(row[1]), row[2], row[3], row[4]))
    return profiles, pe


# ------------------------------------------------------------- mode 2

def _apply_profile(ops: list[tuple], chrom_codes: np.ndarray,
                   start: int, read_len: int) -> np.ndarray | None:
    """Replay an error profile at a genome locus
    (Benchmarker.cpp:1897-1935): '='/'M' copy, 'X'/'S'/'H' copy+permute,
    'I' copy+permute w/o target advance, 'D'/'N' advance target only."""
    seq = np.zeros(read_len, np.uint8)
    q = 0
    r = start
    for n, op in ops:
        if q >= read_len:
            break
        if op in "M=":
            if r + n > len(chrom_codes):
                return None
            seq[q:q + n] = chrom_codes[r:r + n]
            q += n
            r += n
        elif op in "XSH":
            if r + n > len(chrom_codes):
                return None
            seq[q:q + n] = (chrom_codes[r:r + n] + 2) & 3
            q += n
            r += n
        elif op == "I":
            if r + n > len(chrom_codes):
                return None
            seq[q:q + n] = (chrom_codes[r:r + n] + 2) & 3
            q += n
        elif op in "DN":
            r += n
    if q != read_len:
        return None
    return seq


def sim_reads_from_profiles(genome, profiles: list[ObsProfile],
                            n_reads: int, *, pe: bool = False,
                            seed: int = 1):
    """Simulate reads by replaying observed error profiles at random
    length-proportional loci (Benchmarker.cpp SimReads). Returns
    (se_records, pe2_records) of SeqRecord; descriptors carry ground
    truth. Requires >= 100 profiles like the reference
    (Benchmarker.cpp:3704-3710) unless fewer are supplied deliberately."""
    from ..io.fasta import SeqRecord
    rng = np.random.default_rng(seed)
    lens = genome.lengths.astype(np.float64)
    pchrom = lens / lens.sum()
    starts = {i: int(s) for i, s in enumerate(genome.starts)}
    se_recs, pe2_recs = [], []
    pi = 0
    attempts = 0
    while len(se_recs) < n_reads and attempts < n_reads * 50:
        attempts += 1
        prof = profiles[pi % len(profiles)]
        pi += 1
        ops1 = parse_cigar(prof.err_profile)
        frag = ref_len_of(ops1)
        if pe and prof.cigar2:
            frag = max(frag, prof.insert_size)
        ci = int(rng.choice(len(lens), p=pchrom))
        clen = int(genome.lengths[ci])
        if clen < frag + 1:
            continue
        loci = int(rng.integers(0, clen - frag)) if clen > frag else 0
        codes = genome.seq[starts[ci]:starts[ci] + clen]
        seq1 = _apply_profile(ops1, codes, loci, prof.read_len)
        if seq1 is None or int((seq1 >= 4).sum()) > prof.read_len // 20:
            continue
        rid = len(se_recs) + 1
        name = f"SR{rid}"
        chrom = genome.names[ci]
        if pe and prof.cigar2:
            ops2 = parse_cigar(prof.err_profile2)
            loci2 = loci + prof.insert_size - ref_len_of(ops2)
            if loci2 < 0 or loci2 + ref_len_of(ops2) > clen:
                continue
            seq2 = _apply_profile(ops2, codes, loci2, prof.read_len)
            if seq2 is None or int((seq2 >= 4).sum()) > prof.read_len // 20:
                continue
            if prof.strand == "-":
                seq1 = dna.revcomp(seq1)
            if prof.strand2 == "-":
                seq2 = dna.revcomp(seq2)
            se_recs.append(SeqRecord(
                name, f"1 {prof.read_len} {chrom} {loci + 1} "
                f"{prof.strand} {prof.err_profile} {prof.pid}", seq1))
            pe2_recs.append(SeqRecord(
                name, f"2 {prof.read_len} {chrom} {loci2 + 1} "
                f"{prof.strand2} {prof.err_profile2} {prof.pid}", seq2))
        else:
            if prof.strand == "-":
                seq1 = dna.revcomp(seq1)
            se_recs.append(SeqRecord(
                name, f"0 {prof.read_len} {chrom} {loci + 1} "
                f"{prof.strand} {prof.err_profile} {prof.pid}", seq1))
    return se_recs, pe2_recs


# ------------------------------------------------------------- mode 3

@dataclass
class GroundTruth:
    name: str
    pe2: bool
    read_len: int
    chrom: str
    start: int            # 0-based
    strand: str
    cigar: str
    aligned: bool = False
    potential: int = 0


def load_ground_truth(*fasta_paths) -> dict:
    """Parse ground truth from simulated-read descriptors
    (">SRn pe len chrom start1 strand cigar profid")."""
    from ..io.fasta import read_seqs
    gt: dict[tuple, GroundTruth] = {}
    for path in fasta_paths:
        for rec in read_seqs(path):
            parts = rec.descr.split()
            if len(parts) < 6:
                continue
            pe_flag, rl, chrom, start1, strand, cig = parts[:6]
            g = GroundTruth(rec.name, pe_flag == "2", int(rl), chrom,
                            int(start1) - 1, strand, cig)
            g.potential = potential_match_bases(parse_cigar(cig),
                                                sh_as_match=True)
            gt[(rec.name, g.pe2)] = g
    return gt


@dataclass
class MagicScore:
    n_ground_truth: int = 0
    n_scored: int = 0
    n_unscored: int = 0
    n_err_chrom: int = 0
    n_err_strand: int = 0
    n_err_pe: int = 0
    bases_correct: int = 0
    bases_incorrect: int = 0
    bases_unclaimed: int = 0
    total_potential: int = 0
    overlap_hist: np.ndarray = field(
        default_factory=lambda: np.zeros(101, np.int64))

    def measures(self, fbeta_bases: float = 0.1,
                 fbeta_reads: float = 0.1) -> dict:
        rb = (self.bases_correct + self.bases_incorrect) / \
            max(self.total_potential, 1)
        pb = self.bases_correct / max(self.bases_correct
                                      + self.bases_incorrect, 1)
        rr = self.n_scored / max(self.n_ground_truth, 1)
        pr = (self.n_scored - (self.n_err_chrom + self.n_err_strand
                               + self.n_err_pe)) / max(self.n_scored, 1)

        def fb(p, r, beta):
            b2 = beta * beta
            d = b2 * p + r
            return (1 + b2) * p * r / d if d else 0.0
        return {"recall_bases": rb, "precision_bases": pb,
                "recall_reads": rr, "precision_reads": pr,
                "f1_bases": fb(pb, rb, 1.0), "f1_reads": fb(pr, rr, 1.0),
                "fbeta_bases": fb(pb, rb, fbeta_bases),
                "fbeta_reads": fb(pr, rr, fbeta_reads)}


def score_alignments(sam_path, ground_truth: dict, *,
                     pe: bool = False) -> MagicScore:
    """Score a SAM against MAGIC ground truth at base level
    (Benchmarker.cpp:2600-2763 + ActualMatchBases)."""
    from ..io.sam import read_sam
    sc = MagicScore(n_ground_truth=len(ground_truth))
    for rec in read_sam(sam_path):
        if rec.flag & 0x900:
            continue
        if not rec.is_mapped:
            continue
        is_pe2 = bool(rec.flag & 0x80)
        g = ground_truth.get((rec.qname, is_pe2))
        if g is None:
            sc.n_unscored += 1
            continue
        sc.n_scored += 1
        if g.aligned:
            sc.total_potential += g.potential
        g.aligned = True
        if g.potential <= 0:
            sc.overlap_hist[0] += 1
            continue
        if rec.rname != g.chrom:
            sc.bases_incorrect += g.potential
            sc.n_err_chrom += 1
            sc.overlap_hist[0] += 1
            continue
        if ("-" if rec.is_reverse else "+") != g.strand:
            sc.bases_incorrect += g.potential
            sc.n_err_strand += 1
            sc.overlap_hist[0] += 1
            continue
        claim_ops = parse_cigar(rec.cigar)
        claim_len = read_len_of(claim_ops)
        if claim_len > g.read_len:
            sc.bases_incorrect += g.read_len
            sc.overlap_hist[0] += 1
            continue
        if claim_len < g.read_len:
            # silently trimmed: unclaimed remainder, claimed incorrect
            sc.bases_unclaimed += g.read_len - claim_len
            sc.bases_incorrect += claim_len
            sc.overlap_hist[0] += 1
            continue
        truth_loci = expand_ref_loci(parse_cigar(g.cigar), g.start,
                                     g.read_len)
        claim_loci = expand_ref_loci(claim_ops, rec.pos - 1, g.read_len)
        if g.strand == "-":
            truth_loci = truth_loci[::-1]
        both = (truth_loci >= 0) & (claim_loci >= 0)
        correct = int((both & (truth_loci == claim_loci)).sum())
        incorrect = int((claim_loci >= 0).sum()) - correct
        sc.bases_correct += correct
        sc.bases_incorrect += incorrect
        sc.overlap_hist[min(100, (correct * 100 + 50) // g.potential)] += 1
    for g in ground_truth.values():
        sc.total_potential += g.potential
        if not g.aligned:
            sc.bases_unclaimed += g.potential
    return sc


def limit_reads(in_path, out_path, max_reads: int) -> int:
    """mode 0 (eBMLimitReads): pass through the first max_reads reads."""
    from ..io.fasta import read_seqs, write_fasta, write_fastq
    recs = []
    for rec in read_seqs(in_path):
        recs.append(rec)
        if len(recs) >= max_reads:
            break
    if recs and getattr(recs[0], "qual", None) is not None:
        write_fastq(out_path, recs)
    else:
        write_fasta(out_path, recs)
    return len(recs)
