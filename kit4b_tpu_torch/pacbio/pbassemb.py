"""contigs / eccontigs: overlap-layout-consensus over corrected reads, the
port of kit4b_tpu/pacbio/pbassemb.py; the SW batches run on `device`.

Capability parity with CPBAssemb + CAssembGraph (pacbiokit4b/PBAssemb.cpp,
AssembGraph.cpp: vertices/fwd+rev edges, containment removal, path
extraction) and CPBECContigs (PBECContigs.cpp: contig polishing with
corrected reads).

Overlap confirmation is the batched banded SW engine on the device; the graph
walk (greedy best-overlap layout) is host-side — candidate counts are tiny
after correction. Both strands are handled by seeding each probe and its
reverse complement against the read index."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import SeqRecord
from .consensus import ConsensusBuilder
from .ecreads import ECParams, _candidates, build_read_index
from .sswd import SWScores, banded_sw_batch


@dataclass
class AssembParams:
    min_overlap: int = 500           # accepted overlap length
    min_identity: float = 0.9        # matches / aligned cols
    band: int = 256                  # corrected reads drift little
    batch: int = 32
    sw: SWScores = field(default_factory=lambda: SWScores(1, -3, -4, -2))
    seed: ECParams = field(default_factory=lambda: ECParams(
        min_read_len=0, band=256, min_seed_cores=20))


def _revcomp(s: np.ndarray) -> np.ndarray:
    r = s[::-1]
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def _overlaps(records, p: AssembParams, device="cuda"):
    """Confirmed overlaps: (a, b, orient, a_rng, b_rng, score, ident)."""
    index, g = build_read_index(records)
    seqs = [np.asarray(r.codes, np.uint8) for r in records]
    jobs = []   # (a, b, orient, diag, probe_codes)
    for a, c in enumerate(seqs):
        for orient, probe in ((0, c), (1, _revcomp(c))):
            for b, d in _candidates(index, g, probe, a, p.seed):
                if orient == 0 and b <= a:
                    continue    # fwd pairs counted once; rc needs both dirs
                jobs.append((a, b, orient, d, probe))
    out = []
    for s in range(0, len(jobs), p.batch):
        chunk = jobs[s: s + p.batch]
        B = p.batch
        Lp = max(len(j[4]) for j in chunk)
        Lt = max(len(seqs[j[1]]) for j in chunk)
        probes = np.full((B, Lp), 0x0F, np.uint8)
        targets = np.full((B, Lt), 0x0F, np.uint8)
        plens = np.zeros(B, np.int32)
        tlens = np.zeros(B, np.int32)
        diag0 = np.zeros(B, np.int32)
        for i, (a, b, orient, d, probe) in enumerate(chunk):
            probes[i, :len(probe)] = probe
            targets[i, :len(seqs[b])] = seqs[b]
            plens[i] = len(probe)
            tlens[i] = len(seqs[b])
            diag0[i] = d
        res = banded_sw_batch(probes, plens, targets, tlens, diag0,
                              band=p.band, scores=p.sw, device=device)
        for i, (a, b, orient, d, probe) in enumerate(chunk):
            al = res[i]
            cols = sum(n for op, n in al.ops)
            if cols < p.min_overlap or cols == 0:
                continue
            ident = al.matches / max(al.matches + al.mismatches, 1)
            if ident < p.min_identity:
                continue
            out.append((a, b, orient, (al.p_start, al.p_end),
                        (al.t_start, al.t_end), al.score, ident))
    return out


def assemble(records: list[SeqRecord],
             params: AssembParams | None = None,
             device="cuda") -> list[SeqRecord]:
    """Greedy best-overlap layout: containments dropped, dovetail edges
    taken best-first, non-branching paths spliced into contigs."""
    p = params or AssembParams()
    seqs = [np.asarray(r.codes, np.uint8) for r in records]
    n = len(seqs)
    contained = set()
    edges = []   # (score, a, b, orient, a_rng, b_rng)
    for a, b, orient, ar, br, score, ident in _overlaps(records, p, device):
        La, Lb = (len(seqs[a]) if orient == 0 else len(seqs[a])), len(seqs[b])
        slack = 50
        a_full = ar[0] <= slack and ar[1] >= La - slack
        b_full = br[0] <= slack and br[1] >= Lb - slack
        if a_full and not b_full:
            contained.add(a)
        elif b_full and not a_full:
            contained.add(b)
        elif not (a_full and b_full):
            edges.append((score, a, b, orient, ar, br))
    # greedy dovetail pairing on read ends: suffix of a joins prefix of b.
    # Forward-orientation joins only; rc overlaps contribute containment
    # evidence (full bidirected layout is a later round).
    edges.sort(key=lambda e: -e[0])
    slack = 50
    used_tail, used_head = set(), set()
    nxt = {}
    for score, a, b, orient, ar, br in edges:
        if orient != 0 or a in contained or b in contained:
            continue
        if ar[1] >= len(seqs[a]) - slack and br[0] <= slack:
            if a in used_tail or b in used_head:
                continue
            used_tail.add(a)
            used_head.add(b)
            nxt[a] = (b, ar, br)
    has_pred = {b for b, _, _ in nxt.values()}
    contigs = []
    visited = set()
    for a in range(n):
        if a in contained or a in has_pred or a in visited:
            continue
        visited.add(a)
        contig = seqs[a]
        cur = a
        while cur in nxt:
            b, ar, br = nxt[cur]
            if b in visited:
                break
            visited.add(b)
            # trim cur's unaligned tail, append b past its aligned end
            tail = len(seqs[cur]) - ar[1]
            if tail:
                contig = contig[:-tail]
            contig = np.concatenate([contig, seqs[b][br[1]:]])
            cur = b
        contigs.append(contig)
    contigs.sort(key=len, reverse=True)
    return [SeqRecord(f"contig_{i+1}", f"len={len(c)}", c)
            for i, c in enumerate(contigs)]


def polish_contigs(contigs: list[SeqRecord], reads: list[SeqRecord],
                   ec: ECParams | None = None,
                   device="cuda") -> list[SeqRecord]:
    """eccontigs: error-correct assembled contigs with (corrected) reads —
    CPBECContigs equivalent: contig as consensus probe, reads as evidence."""
    p = ec or ECParams(min_read_len=0, min_corrected_len=0)
    index, g = build_read_index(reads)
    out = []
    for ci, contig in enumerate(contigs):
        probe = np.asarray(contig.codes, np.uint8)
        cands = _candidates(index, g, probe, -1, p)
        cb = ConsensusBuilder(probe)
        Lp = len(probe)
        for s in range(0, len(cands), p.batch):
            chunk = cands[s: s + p.batch]
            B = p.batch
            Lt = max(int(g.lengths[t]) for t, _ in chunk)
            probes = np.full((B, Lp), 0x0F, np.uint8)
            targets = np.full((B, Lt), 0x0F, np.uint8)
            plens = np.zeros(B, np.int32)
            tlens = np.zeros(B, np.int32)
            diag0 = np.zeros(B, np.int32)
            for b, (t, d) in enumerate(chunk):
                probes[b] = probe
                ts = int(g.starts[t])
                tl = int(g.lengths[t])
                targets[b, :tl] = g.seq[ts: ts + tl]
                plens[b] = Lp
                tlens[b] = tl
                diag0[b] = d
            res = banded_sw_batch(probes, plens, targets, tlens, diag0,
                                  band=p.band, scores=p.sw, device=device)
            for b, a in enumerate(res[:len(chunk)]):
                if (a.score >= p.min_score
                        and a.p_end - a.p_start >= p.min_align_len):
                    t = chunk[b][0]
                    ts = int(g.starts[t])
                    cb.add(a, g.seq[ts: ts + int(g.lengths[t])])
        out.append(SeqRecord(contig.name, f"polished n={cb.n_overlaps}",
                             cb.call(min_coverage=p.min_coverage)))
    return out
