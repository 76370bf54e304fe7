"""radseq: RAD-seq stack assembly with in-stack variant calling, the port's
copy of kit4b_tpu/assembly/radseq.py (host only;
tests/test_torch_rehomed.py holds it equal to the original statement for
statement): P1 reads bucketed by their restriction-site prefix and split
into stacks against each stack's consensus, polymorphic columns written as
VCF 4.1, and the P2 mates of a stack overlap-assembled into a locus
contig.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .. import dna


@dataclass
class Stack:
    consensus: np.ndarray        # uint8 codes
    depth: int
    read_ids: list
    variants: list = field(default_factory=list)
    # each variant: (pos, ref_code, alt_code, depth, alt_depth)
    p2_contig: np.ndarray | None = None


def _column_counts(mat: np.ndarray) -> np.ndarray:
    """[D, L] codes -> [L, 4] base counts (codes >3 ignored)."""
    counts = np.zeros((mat.shape[1], 4), np.int32)
    for b in range(4):
        counts[:, b] = (mat == b).sum(axis=0)
    return counts


def stack_p1(records: list, *, key_len: int = 24, min_depth: int = 10,
             max_sub_pct: float = 1.0, end_float: int = 5,
             min_var_depth: int = 2,
             min_var_prop: float = 0.2) -> list[Stack]:
    """Pile P1 reads into stacks.

    Reads are bucketed by their exact key_len prefix (the restriction
    site anchors P1 5' ends, StackSeqs.h p1stackend: only the 3' end
    floats), then each bucket is split against its consensus: reads
    whose substitution rate vs the consensus exceeds max_sub_pct seed
    new stacks. Stacks below min_depth are dropped.
    """
    buckets: dict[bytes, list[int]] = defaultdict(list)
    for i, rec in enumerate(records):
        if len(rec.codes) < key_len:
            continue
        key = bytes(np.minimum(rec.codes[:key_len], 4))
        buckets[key].append(i)

    stacks: list[Stack] = []
    for ids in buckets.values():
        pending = [ids]
        while pending:
            group = pending.pop()
            if len(group) < min_depth:
                continue
            min_len = min(len(records[i].codes) for i in group)
            # 3' float: align on the shared prefix, trim to the
            # common length (floating ends beyond end_float excluded)
            use_len = max(key_len, min_len - end_float)
            mat = np.stack([records[i].codes[:use_len] for i in group])
            counts = _column_counts(mat)
            cons = counts.argmax(axis=1).astype(np.uint8)
            mm = (mat != cons[None, :]).sum(axis=1)
            ok = mm <= max(1, int(use_len * max_sub_pct / 100.0))
            members = [g for g, o in zip(group, ok) if o]
            rejects = [g for g, o in zip(group, ok) if not o]
            if len(members) >= min_depth:
                cmat = mat[ok]
                ccounts = _column_counts(cmat)
                # consensus from post-filter member counts so the fasta
                # and the VCF REF derive from the same pileup
                cons = ccounts.argmax(axis=1).astype(np.uint8)
                variants = []
                depth = len(members)
                for pos in range(use_len):
                    order = np.argsort(-ccounts[pos])
                    ref, alt = int(order[0]), int(order[1])
                    ad = int(ccounts[pos, alt])
                    if ad >= min_var_depth and \
                            ad / max(depth, 1) >= min_var_prop:
                        variants.append((pos, ref, alt, depth, ad))
                stacks.append(Stack(cons, depth, members, variants))
            if len(rejects) >= min_depth and len(rejects) < len(group):
                pending.append(rejects)
    stacks.sort(key=lambda s: -s.depth)
    return stacks


def assemble_p2(stack: Stack, p2_records: list, *,
                min_overlap: int = 30,
                max_sub_pct: float = 1.0) -> np.ndarray | None:
    """Greedy overlap-consensus of the stack members' P2 mates into a
    locus contig (the reference's P2 assembly, p2minovrl/
    p2maxovrlsubrate flags). P2 mates shear randomly, so they tile the
    locus; merge by best suffix-prefix overlap."""
    seqs = [p2_records[i].codes for i in stack.read_ids
            if i < len(p2_records)]
    seqs = [s for s in seqs if len(s) >= min_overlap]
    if not seqs:
        return None
    seqs.sort(key=len, reverse=True)
    contig = np.array(seqs[0], np.uint8)
    merged = True
    remaining = seqs[1:]
    while merged and remaining:
        merged = False
        keep = []
        for s in remaining:
            pos = _best_overlap(contig, s, min_overlap, max_sub_pct)
            if pos is None:
                keep.append(s)
                continue
            if pos + len(s) > len(contig):       # extends 3'
                contig = np.concatenate([contig, s[len(contig) - pos:]])
            merged = True
        remaining = keep
    return contig


def _best_overlap(contig: np.ndarray, s: np.ndarray, min_overlap: int,
                  max_sub_pct: float):
    """Best placement of s against contig (suffix-prefix or contained);
    vectorized over all offsets via a correlation count."""
    L, M = len(contig), len(s)
    best, best_mm = None, None
    for pos in range(-0, L - min_overlap + 1):
        ov = min(L - pos, M)
        mm = int((contig[pos:pos + ov] != s[:ov]).sum())
        if mm <= max(1, int(ov * max_sub_pct / 100.0)):
            if best_mm is None or mm < best_mm:
                best, best_mm = pos, mm
    return best


def write_stacks_fasta(path, stacks: list, prefix: str = "stack") -> None:
    from ..io.fasta import SeqRecord, write_fasta
    recs = []
    for i, s in enumerate(stacks):
        recs.append(SeqRecord(f"{prefix}{i + 1}",
                              f"depth={s.depth}", s.consensus))
        if s.p2_contig is not None:
            recs.append(SeqRecord(f"{prefix}{i + 1}_p2",
                                  f"depth={s.depth}", s.p2_contig))
    write_fasta(path, recs)


def write_stacks_vcf(path, stacks: list, prefix: str = "stack") -> None:
    """VCF 4.1 of in-stack polymorphic columns (the reference's -O)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n##source=kit4b_tpu_radseq\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i, s in enumerate(stacks):
            for pos, ref, alt, depth, ad in s.variants:
                f.write(f"{prefix}{i + 1}\t{pos + 1}\t.\t"
                        f"{'ACGT'[ref]}\t{'ACGT'[alt]}\t.\tPASS\t"
                        f"DP={depth};AD={ad}\n")


def radseq_process(p1_records: list, p2_records: list | None = None,
                   **kw) -> list[Stack]:
    """Full RADseq flow: stack P1, optionally assemble P2 contigs."""
    p2_kw = {k: kw.pop(k) for k in ("min_overlap",) if k in kw}
    stacks = stack_p1(p1_records, **kw)
    if p2_records:
        for s in stacks:
            s.p2_contig = assemble_p2(s, p2_records, **p2_kw)
    return stacks
