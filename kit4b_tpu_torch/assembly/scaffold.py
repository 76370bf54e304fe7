"""PE-link contig scaffolding from SAM alignments (`pescaffold` equivalent)
and sequence-aware scaffolding (`scaffold`): the port's copy of
kit4b_tpu/assembly/scaffold.py, whose mate alignment runs the port's
KAligner on an explicit device.

Mirrors CPEScaffold (ngskit4b/PEScaffold.cpp): pairs whose mates aligned to
different contigs vote for joining those contigs; orientation comes from the
mates' strands (FR library: each mate points INTO its fragment, so the mate's
strand says which contig end faces the gap). Edges weighted by supporting
pair count; scaffold paths built greedily with each contig end used at most
once and union-find preventing cycles (the CAssembGraph vertex/edge +
component logic, ngskit4b/AssembGraph.cpp:126-210, as plain host graph code).

Output: scaffolded multifasta with N gaps (ReportScaffoldSets parity,
Scaffolder.cpp:1510).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io.fasta import SeqRecord
from ..io.sam import read_sam


@dataclass
class ScaffoldParams:
    min_links: int = 2          # pairs required to accept a join
    default_gap: int = 100      # N gap when no estimate available
    min_gap: int = 10
    insert_size: int = 500      # PE library mean insert (gap estimation)


def _end_of(strand_fwd: bool):
    # FR library: forward-aligned mate faces right (3'/R end of its contig
    # points at the gap); reverse-aligned mate faces left (L end).
    return "R" if strand_fwd else "L"


def collect_links(sam1, sam2):
    """Pair mate SAM streams by qname; yield inter-contig link votes
    ((ctgA, endA), (ctgB, endB))."""
    m1 = {}
    for r in sam1:
        if r.is_mapped:
            m1[r.qname] = r
    for r2 in sam2:
        if not r2.is_mapped:
            continue
        r1 = m1.get(r2.qname)
        if r1 is None or r1.rname == r2.rname:
            continue
        yield ((r1.rname, _end_of(not r1.is_reverse)),
               (r2.rname, _end_of(not r2.is_reverse)))


def collect_seq_links(index, pe1_records, pe2_records,
                      params: ScaffoldParams | None = None, *,
                      aligner=None, max_subs: int = 5, device="cuda"):
    """Sequence-aware link generation (CScaffolder::GenSeqEdges,
    ngskit4b/Scaffolder.cpp:1713): align PE mate reads directly onto the
    contig index (sense+antisense handled by the aligner) and vote for
    joining the contig ends that face each other, with a per-pair gap
    estimate gap = insert - dA - dB where d* is the mate's distance to its
    facing contig end.

    Yields ((ctgA, endA), (ctgB, endB), gap_estimate).
    """
    from ..align.kalign import KAligner, NAR_ACCEPTED
    p = params or ScaffoldParams()
    al = aligner or KAligner(index, max_subs=max_subs, device=device)
    g = index.genome

    def locate(records):
        out = {}
        for rec, res in al.align_records(records):
            if res.nar != NAR_ACCEPTED:
                continue
            ci = int(np.searchsorted(g.starts, res.pos, side="right") - 1)
            out[rec.name] = (ci, int(res.pos - g.starts[ci]),
                             res.strand, len(rec.codes))
        return out

    m1 = locate(pe1_records)
    m2 = locate(pe2_records)
    for qname, (c1, p1, s1, l1) in m1.items():
        hit2 = m2.get(qname)
        if hit2 is None:
            continue
        c2, p2, s2, l2 = hit2
        if c1 == c2:
            continue
        # forward mate faces the R end; distance from read start to that
        # end; reverse mate faces the L end, distance to contig start
        if s1 == 0:
            e1, d1 = "R", int(g.lengths[c1]) - p1
        else:
            e1, d1 = "L", p1 + l1
        if s2 == 0:
            e2, d2 = "R", int(g.lengths[c2]) - p2
        else:
            e2, d2 = "L", p2 + l2
        gap = p.insert_size - d1 - d2
        yield ((g.names[c1], e1), (g.names[c2], e2), gap)


class _UnionFind:
    def __init__(self):
        self.p = {}

    def find(self, x):
        self.p.setdefault(x, x)
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.p[ra] = rb
        return True


def build_scaffolds(links, contig_names, params: ScaffoldParams | None = None):
    """Greedy scaffold path construction from link votes.

    Returns list of paths; each path is [(contig, flip:bool), ...].
    """
    p = params or ScaffoldParams()
    votes = defaultdict(int)
    gap_sum = defaultdict(int)
    for link in links:
        a, b = link[0], link[1]
        key = tuple(sorted((a, b)))
        votes[key] += 1
        if len(link) > 2:
            gap_sum[key] += link[2]
    edges = sorted(((n, a, b) for (a, b), n in votes.items()
                    if n >= p.min_links), reverse=True)

    used_ends = set()
    uf = _UnionFind()
    adj = defaultdict(list)  # (ctg,end) -> (other ctg, other end)
    gaps = {}                # frozenset of the two ends -> gap estimate
    for n, a, b in edges:
        if a in used_ends or b in used_ends:
            continue
        if not uf.union(a[0], b[0]):
            continue
        used_ends.add(a)
        used_ends.add(b)
        adj[a].append(b)
        adj[b].append(a)
        key = tuple(sorted((a, b)))
        if key in gap_sum:
            gaps[frozenset((a, b))] = max(p.min_gap,
                                          gap_sum[key] // votes[key])

    # walk chains: a contig's two ends are implicitly connected internally
    visited = set()
    paths = []
    for name in contig_names:
        if name in visited:
            continue
        # find a terminal end: an end with no external link, preferring L
        start_end = None
        for e in ("L", "R"):
            if (name, e) not in adj:
                start_end = e
                break
        if start_end is None:
            # both ends linked -> middle of a chain or cycle; skip here,
            # it will be reached from a terminal (cycles were prevented)
            continue
        path = []
        cur, enter = name, start_end
        while True:
            visited.add(cur)
            # entering at `enter`: orientation fwd if entered at L
            path.append((cur, enter != "L"))
            exit_end = "R" if enter == "L" else "L"
            nxts = adj.get((cur, exit_end))
            if not nxts:
                break
            nxt_ctg, nxt_end = nxts[0]
            if nxt_ctg in visited:
                break
            g = gaps.get(frozenset(((cur, exit_end), (nxt_ctg, nxt_end))))
            if g is not None:
                path.append(("", g))   # gap marker consumed by writer
            cur, enter = nxt_ctg, nxt_end
        paths.append(path)
    for name in contig_names:
        if name not in visited:
            paths.append([(name, False)])
            visited.add(name)
    return paths


def write_scaffolds(path, paths, contig_seqs: dict,
                    params: ScaffoldParams | None = None):
    """Emit scaffolded multifasta with N gaps."""
    from ..io.fasta import write_fasta
    p = params or ScaffoldParams()
    dflt_gap = max(p.min_gap, p.default_gap)
    recs = []
    for i, pth in enumerate(paths, start=1):
        parts = []
        names = []
        pending_gap = None
        for name, flip in pth:
            if name == "":            # gap marker: flip holds the estimate
                pending_gap = max(p.min_gap, int(flip))
                continue
            if parts:
                n_gap = pending_gap if pending_gap is not None else dflt_gap
                parts.append(np.full(n_gap, dna.BASE_N, np.uint8))
            pending_gap = None
            s = contig_seqs[name]
            parts.append(dna.revcomp(s) if flip else s)
            names.append(name)
        recs.append(SeqRecord(
            f"scaffold{i:05d}", f"contigs={','.join(names)}",
            np.concatenate(parts)))
    write_fasta(path, recs)
    return recs


def scaffold_contigs(contigs_fasta, pe1_path, pe2_path, out_path,
                     params: ScaffoldParams | None = None, *,
                     max_subs: int = 5, min_contig: int = 0,
                     device="cuda"):
    """Sequence-aware scaffolding (CScaffolder::ScaffoldAssemble,
    ngskit4b/Scaffolder.cpp:788): contigs indexed, PE mates aligned onto
    them on-device, inter-contig end links voted with insert-derived gap
    estimates, greedy paths emitted with per-join N gaps."""
    from ..index.sfx_index import SfxIndex
    from ..io.fasta import Genome, read_seqs
    p = params or ScaffoldParams()
    contigs = [r for r in read_seqs(contigs_fasta)
               if len(r.codes) >= min_contig]
    contig_seqs = {r.name: r.codes for r in contigs}
    g = Genome.from_records(contigs)
    index = SfxIndex.build(g)
    links = list(collect_seq_links(index, read_seqs(pe1_path),
                                   read_seqs(pe2_path), p,
                                   max_subs=max_subs, device=device))
    paths = build_scaffolds(links, list(contig_seqs), p)
    recs = write_scaffolds(out_path, paths, contig_seqs, p)
    return paths, recs


def pescaffold(sam1_path, sam2_path, contigs_fasta, out_path,
               params: ScaffoldParams | None = None):
    """End-to-end pescaffold: PE SAMs + contig fasta -> scaffolded fasta."""
    from ..io.fasta import read_seqs
    contig_seqs = {r.name: r.codes for r in read_seqs(contigs_fasta)}
    links = list(collect_links(read_sam(sam1_path), read_sam(sam2_path)))
    paths = build_scaffolds(links, list(contig_seqs), params)
    recs = write_scaffolds(out_path, paths, contig_seqs, params)
    return paths, recs
