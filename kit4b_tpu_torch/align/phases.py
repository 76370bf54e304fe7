"""kalign post-alignment phases (reference CKAligner phase list): the
port's copy of kit4b_tpu/align/phases.py, host numpy over the accepted
results and the genome byte array:

- AutoTrimFlanks        (ngskit4b/KAligner.cpp:656 -> AutoTrimFlanks)
- PCR5PrimerCorrect     (KAligner.cpp:645 -> :2119)
- Loci base constraints (KAligner.cpp:629 IdentifyConstraintViolations
                         -> :2648 AcceptLociConstraints)
- AssignMultiMatches    (KAligner.cpp:617 -> :5092, clustering scores
                         :4960-5090 with cClust* constants KAligner.h:96-101)
- the multiloci random pick and report-all (--mlmode 2 and 5)
- the orphan splice and microInDel removal (KAligner.cpp:2406 / :2501)
- the none-aligned and multialigned side files (KAligner.cpp:3833 / :3931)

Each takes/returns the (rec, res) materialized list form used between
kalign.align_records and kalign.write_sam. `pcr5_primer_correct` writes
the corrected bases into `rec.codes` in place, as the JAX package does: each
record must own its codes (`io.fasta.read_seqs` gives every read its own
array). `assign_multi_random` draws from numpy's seeded generator, so the
same read gets the same locus as in the JAX package.
"""
from __future__ import annotations

import csv
import gzip
import re

import numpy as np

from .. import dna
from .kalign import NAR_ACCEPTED, NAR_MULTI, NAR_NOHIT, NAR_NS, AlignResult

# reference clustering constants (KAligner.h:96-101)
CLUST_MIN_OVERLAP = 10
CLUST_UNIQUE_SCORE = 5
CLUST_MULTI_SCORE = 1
CLUST_SCALE_FACT = 10
MH_MIN_SCORE = 50

NAR_TRIM = "trim"               # eNARTrim
NAR_CONSTRAINED = "constrained"  # eNARLociConstrained


def _oriented(rec, res) -> np.ndarray:
    r = rec.codes
    return dna.revcomp(r) if res.strand else r


def _mism(genome_seq, rec, res) -> np.ndarray:
    """Boolean mismatch vector (read oriented to genome coords)."""
    L = len(rec.codes)
    tgt = genome_seq[res.pos:res.pos + L]
    r = _oriented(rec, res)
    return (tgt != r) | (tgt >= 4) | (r >= 4)


def auto_trim_flanks(aligned: list, genome_seq: np.ndarray,
                     min_flank_exacts: int, pe: bool = False) -> dict:
    """Trim accepted alignments back to min_flank_exacts exactly matching
    flanking bases; reads that cannot be trimmed are demoted to NAR_TRIM
    (reference AutoTrimFlanks). Mutates res in place: sets res.trim_left/
    trim_right/mm; returns counters."""
    n_trim = n_killed = 0
    for rec, res in aligned:
        if res.nar != NAR_ACCEPTED or res.cigar is not None:
            continue
        L = len(rec.codes)
        mism = _mism(genome_seq, rec, res)
        min_trimmed = max((L + 1) // 2, 15)
        # 5' -> 3': first completion of a min_flank_exacts exact run
        bound5 = L if not pe else L // 3
        exact = 0
        left_ofs = None
        for i in range(min(L - min_trimmed + 1, bound5)):
            if mism[i]:
                exact = 0
                continue
            exact += 1
            if exact == min_flank_exacts:
                left_ofs = i - (min_flank_exacts - 1)
                break
        if left_ofs is None:
            if pe:
                left_ofs = 0
            else:
                res.nar = NAR_TRIM
                n_killed += 1
                continue
        # 3' -> 5'
        bound3 = 0 if not pe else (L * 2) // 3
        exact = 0
        right_ofs = None
        i = L - 1
        while i >= max(left_ofs + min_trimmed, bound3 + 1) - 1 and i >= 0:
            if mism[i]:
                exact = 0
            else:
                exact += 1
                if exact == min_flank_exacts:
                    right_ofs = i + min_flank_exacts
                    break
            i -= 1
        if right_ofs is None:
            if pe:
                right_ofs = L
            else:
                res.nar = NAR_TRIM
                n_killed += 1
                continue
        tl, tr = left_ofs, L - right_ofs
        if tl or tr:
            res.trim_left = tl
            res.trim_right = tr
            res.pos += tl
            res.mm = int(mism[tl:L - tr].sum())
            res.cigar = (f"{tl}S" if tl else "") + \
                f"{L - tl - tr}M" + (f"{tr}S" if tr else "")
            n_trim += 1
    return {"trimmed": n_trim, "removed": n_killed}


def pcr5_primer_correct(aligned: list, genome_seq: np.ndarray,
                        max_sub_rate: int, klen: int) -> dict:
    """Correct 5' PCR random-primer artefact substitutions within the first
    klen read bases until the read meets max_sub_rate subs per 100bp;
    corrected bases are rewritten in the read (reference PCR5PrimerCorrect).
    """
    n_reads = n_bases = 0
    if klen < 1:
        return {"corrected_reads": 0, "corrected_bases": 0}
    for rec, res in aligned:
        if res.nar != NAR_ACCEPTED or res.cigar is not None:
            continue
        L = len(rec.codes)
        max_mm = (max_sub_rate * L + 50) // 100
        if res.mm <= max_mm:
            continue
        mism = _mism(genome_seq, rec, res)
        cur = res.mm
        fixable = np.nonzero(mism[:klen])[0]
        if cur - len(fixable) > max_mm:
            continue    # cannot reach target rate within the 5' window
        tgt = genome_seq[res.pos:res.pos + L]
        r = _oriented(rec, res)
        for i in fixable:
            r[i] = tgt[i]
            n_bases += 1
            cur -= 1
            if cur <= max_mm:
                break
        # write corrected bases back in read orientation
        rec.codes[:] = dna.revcomp(r) if res.strand else r
        res.mm = cur
        n_reads += 1
    return {"corrected_reads": n_reads, "corrected_bases": n_bases}


def load_loci_constraints(path, genome) -> dict:
    """CSV rows: chrom, loci, allowed bases string (e.g. "AC").
    Returns {concat_pos: allowed-base-code set} (reference -0/--lociconstr,
    tsConstraintLoci)."""
    name2start = {n: int(s) for n, s in zip(genome.names, genome.starts)}
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#") or len(row) < 3:
                continue
            chrom = row[0].strip().strip('"')
            if chrom not in name2start:
                continue
            pos = name2start[chrom] + int(row[1])
            allowed = {int(b) for b in
                       dna.encode(row[2].strip().strip('"').upper())
                       if b < 4}
            out[pos] = allowed
    return out


def identify_constraint_violations(aligned: list, constraints: dict) -> int:
    """Demote accepted reads whose base at a constrained locus is not in
    the allowed set (reference IdentifyConstraintViolations)."""
    if not constraints:
        return 0
    n = 0
    cpos = np.fromiter(constraints.keys(), dtype=np.int64)
    for rec, res in aligned:
        if res.nar != NAR_ACCEPTED:
            continue
        L = len(rec.codes)
        hits = cpos[(cpos >= res.pos) & (cpos < res.pos + L)]
        if len(hits) == 0:
            continue
        r = _oriented(rec, res)
        for p in hits:
            if int(r[p - res.pos]) not in constraints[int(p)]:
                res.nar = NAR_CONSTRAINED
                n += 1
                break
    return n


def assign_multi_random(aligned: list, seed: int = 1) -> int:
    """eMLrand: assign each multialigned read to one of its loci at random
    (deterministic seeded RNG, like the reference's srand-driven pick)."""
    rng = np.random.default_rng(seed)
    n = 0
    for rec, res in aligned:
        if res.nar != NAR_MULTI or res.multi_ids is None \
                or len(res.multi_ids) == 0:
            continue
        ids = [int(h) for h in res.multi_ids
               if int(h) != np.iinfo(np.int32).max]
        if not ids:
            continue
        hid = ids[int(rng.integers(0, len(ids)))]
        res.nar = NAR_ACCEPTED
        res.pos = hid >> 1
        res.strand = hid & 1
        res.n_low = 1
        n += 1
    return n


def expand_multi_all(aligned: list) -> list:
    """eMLall: expand each multialigned read into one record per locus; the
    first is primary, the rest carry SAM flag 0x100 (reference -r5 report
    all match loci up to the -R limit)."""
    out = []
    for rec, res in aligned:
        if res.nar != NAR_MULTI or res.multi_ids is None:
            out.append((rec, res))
            continue
        ids = [int(h) for h in res.multi_ids
               if int(h) != np.iinfo(np.int32).max]
        if not ids:
            out.append((rec, res))
            continue
        for j, hid in enumerate(ids):
            out.append((rec, AlignResult(
                NAR_ACCEPTED, strand=hid & 1, pos=hid >> 1, mm=res.mm,
                n_low=len(ids), secondary=j > 0)))
    return out


def assign_multi_matches(aligned: list, mode: str = "uniq") -> int:
    """Assign multialigned reads to a single locus by clustering with
    unique-read stacks (reference AssignMultiMatches, eMLuniq/eMLcluster).

    Scoring mirrors ProcAssignMultiMatches (KAligner.cpp:4960): each
    candidate locus scores 1 + overlap*cClustUniqueScore/cClustScaleFact per
    overlapping (>= cClustMultiOverLap bp) unique accepted read; the best
    locus is assigned when its score >= cMHminScore and >= 2x the next
    best. Returns the number of reads assigned."""
    # coverage events from unique accepted reads, per concat position
    starts = []
    ends = []
    for rec, res in aligned:
        if res.nar == NAR_ACCEPTED:
            starts.append(res.pos)
            ends.append(res.pos + len(rec.codes))
    if not starts:
        return 0
    starts = np.sort(np.asarray(starts, np.int64))
    ends = np.sort(np.asarray(ends, np.int64))

    def cluster_score(p: int, L: int) -> int:
        # unique reads overlapping [p+MIN_OVL, p+L-MIN_OVL) by >= MIN_OVL:
        # reads with start < p+L-MIN_OVL and end > p+MIN_OVL
        n_over = (np.searchsorted(starts, p + L - CLUST_MIN_OVERLAP)
                  - np.searchsorted(ends, p + CLUST_MIN_OVERLAP,
                                    side="right"))
        if n_over <= 0:
            return 0
        # approximate per-read overlap by the read length cap (reference
        # caps Overlap at the hit length); score per overlapping read
        return int(n_over) * (1 + (L * CLUST_UNIQUE_SCORE)
                              // CLUST_SCALE_FACT)

    n_assigned = 0
    for rec, res in aligned:
        if res.nar != NAR_MULTI or res.multi_ids is None:
            continue
        L = len(rec.codes)
        scores = [(cluster_score(int(h) >> 1, L), int(h))
                  for h in res.multi_ids
                  if int(h) != np.iinfo(np.int32).max]
        if len(scores) < 2:
            continue
        scores.sort(reverse=True)
        best, hid = scores[0]
        nxt = scores[1][0]
        if best < MH_MIN_SCORE or best < 2 * nxt:
            continue
        res.nar = NAR_ACCEPTED
        res.pos = hid >> 1
        res.strand = hid & 1
        res.n_low = 1
        n_assigned += 1
    return n_assigned


# --- orphan splice / microInDel removal (KAligner.cpp:2406 / :2501) -------

NAR_ORPHAN_SPLICE = "orphan_splice"     # eNARSpliceJctn analog
NAR_ORPHAN_INDEL = "orphan_indel"       # eNARmicroInDel analog


def _junction(res) -> tuple | None:
    """(seg0_end, seg1_start) genome coords from a two-segment CIGAR
    (MNM splice / MDM deletion / MIM insertion), as the reference takes
    AdjEndLoci(Seg[0]) / AdjStartLoci(Seg[1])."""
    if not res.cigar:
        return None
    ops = re.findall(r"(\d+)([MIDNS])", res.cigar)
    gpos = res.pos
    seg_end = None
    for ln, op in ops:
        ln = int(ln)
        if op == "M":
            if seg_end is None:
                seg_end = gpos + ln          # end of first segment
            gpos += ln
        elif op in ("D", "N"):
            gpos += ln
        # I/S consume no genome
        if seg_end is not None and op in ("D", "N", "I"):
            return (seg_end, gpos if op != "I" else seg_end)
    return None


def remove_orphan_junctions(aligned: list, kind: str) -> int:
    """Demote accepted splice ('splice', CIGAR N) or microInDel ('indel',
    CIGAR I/D) reads whose junction is not supported by a second read
    within +/-3 bp on both junction coords. Mirrors the reference's
    adjacent-after-sort multiplicity test (KAligner.cpp:2454-2466) and its
    treat-as-unaligned demotion (:2470-2478). Returns demoted count."""
    want = "N" if kind == "splice" else "ID"
    juncts = []
    for i, (rec, res) in enumerate(aligned):
        if res.nar != NAR_ACCEPTED or not res.cigar:
            continue
        if not any(c in res.cigar for c in want):
            continue
        j = _junction(res)
        if j is not None:
            juncts.append((j[0], j[1], i))
    n_removed = 0
    nar_to = NAR_ORPHAN_SPLICE if kind == "splice" else NAR_ORPHAN_INDEL
    if len(juncts) == 1:
        _, res = aligned[juncts[0][2]]
        res.nar = nar_to
        return 1
    juncts.sort()
    supported = set()
    for a, b in zip(juncts, juncts[1:]):
        if abs(a[0] - b[0]) <= 3 and abs(a[1] - b[1]) <= 3:
            supported.add(a[2])
            supported.add(b[2])
    for _, _, i in juncts:
        if i not in supported:
            res = aligned[i][1]
            res.nar = nar_to
            n_removed += 1
    return n_removed


# --- none-aligned / multialigned side files (KAligner.cpp:3833 / :3931) ---

def _write_report_fasta(path, entries, tag: str) -> int:
    """70-column fasta with the reference's descriptor layout
    '>lcl|<tag>|<id> <descr> <id>|<numreads>|<len>'."""
    n = 0
    op = open
    if str(path).endswith(".gz"):
        op = gzip.open
    with op(path, "wt") as f:
        for read_id, rec in entries:
            seq = dna.decode(rec.codes)
            descr = rec.name + ((" " + rec.descr) if rec.descr else "")
            f.write(f">lcl|{tag}|{read_id} {descr} "
                    f"{read_id}|1|{len(seq)}\n")
            for o in range(0, len(seq), 70):
                f.write(seq[o:o + 70] + "\n")
            n += 1
    return n


def report_none_aligned(path, aligned: list) -> int:
    """-j/--nonealign: fasta of reads with no alignment at all (NAR Ns or
    NoHit — KAligner.cpp:3833 ReportNoneAligned)."""
    entries = [(i + 1, rec) for i, (rec, res) in enumerate(aligned)
               if res.nar in (NAR_NOHIT, NAR_NS)]
    return _write_report_fasta(path, entries, "na")


def report_multi_align(path, aligned: list) -> int:
    """-J/--multialign: fasta of multialigned reads
    (KAligner.cpp:3931 ReportMultiAlign)."""
    entries = [(i + 1, rec) for i, (rec, res) in enumerate(aligned)
               if res.nar == NAR_MULTI]
    return _write_report_fasta(path, entries, "ml")
