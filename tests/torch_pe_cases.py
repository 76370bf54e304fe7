"""Inputs shared by the paired-end tests of the port (tests/test_torch_pe_*.py):
one genome as both packages' Genome, SfxIndex and KAligner (the JAX side
imported lazily, so a file that runs without JAX can use the port side),
simulated pairs, and both packages' 2-bit uploads of a batch."""
from __future__ import annotations

import numpy as np

from kit4b_tpu_torch import dna
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord
from kit4b_tpu_torch.sim import simreads


def clean_genome(n: int = 200_000, seed: int = 23) -> Genome:
    """One random chromosome, as tests/test_pe.py's setup."""
    rng = np.random.default_rng(seed)
    return Genome.from_records(
        [SeqRecord("c1", "", rng.integers(0, 4, n).astype(np.uint8))])


def skip_bucket_genome(seed: int = 77) -> Genome:
    """A 160 kbp genome whose 24 bp unit is planted 5,200 times: the
    buckets of its 9-mers hold more than DFLT_SKIP_BUCKET entries."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, 160_000).astype(np.uint8)
    unit = rng.integers(0, 4, 24).astype(np.uint8)
    for i in range(5200):
        p = 100 + i * 30
        s[p:p + 24] = unit
    return Genome.from_records([SeqRecord("c1", "", s)])


class Both:
    """One genome as the port's (g, idx) and the JAX package's, sharing
    the suffix array; aligners of either at a batch size."""

    def __init__(self, g: Genome):
        from kit4b_tpu.index.sfx_index import SfxIndex as JIdx
        from kit4b_tpu.io.fasta import Genome as JG
        self.g = g
        self.idx = SfxIndex.build(g)
        self.jg = JG(list(g.names), g.starts, g.lengths, g.seq)
        self.jidx = JIdx(self.jg, self.idx.lut_k, self.idx.sa_clean,
                         self.idx.lut)

    def aligners(self, batch: int, **kw):
        from kit4b_tpu.align import kalign as jk
        return (jk.KAligner(self.jidx, batch_size=batch, **kw),
                pk.KAligner(self.idx, batch_size=batch, device="cpu", **kw))


def sim_pairs(g: Genome, L: int, n: int, seed: int, ins=(250, 450),
              n_rate: float = 0.0, **kw):
    """[n, L] code matrices of both mates and the mate-1 names."""
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=n, read_len=L, pe=True, pe_insert_min=ins[0],
        pe_insert_max=ins[1], seed=seed, **kw))
    c1 = np.stack([r.codes for r in r1])
    c2 = np.stack([r.codes for r in r2])
    if n_rate:
        rng = np.random.default_rng(seed + 1)
        c1 = np.where(rng.random(c1.shape) < n_rate, dna.BASE_N, c1)
        c2 = np.where(rng.random(c2.shape) < n_rate, dna.BASE_N, c2)
    return c1.astype(np.uint8), c2.astype(np.uint8), [r.name for r in r1]


def records(codes, names, pkg="port"):
    """SeqRecords of either package."""
    if pkg == "jax":
        from kit4b_tpu.io.fasta import SeqRecord as JS
        return [JS(n, "", c) for n, c in zip(names, codes)]
    return [SeqRecord(n, "", c) for n, c in zip(names, codes)]


def uploads(a1, a2):
    """(JAX handles, port handles): r2b1, nl1, r2b2, nl2 of both mates."""
    import jax.numpy as jnp
    import torch

    from kit4b_tpu.align import kalign as jk
    j = [jnp.asarray(x) for a in (a1, a2) for x in jk.pack_reads_2bit(a)[:2]]
    p = [torch.from_numpy(x) for a in (a1, a2)
         for x in pk.pack_reads_2bit(a)]
    return j, p


def pair_key(pp):
    """A PePair of either package as comparable plain values."""
    def res(r):
        return None if r is None else (r.nar, int(r.strand), int(r.pos),
                                       int(r.mm), int(r.n_low))
    return (pp.nar, res(pp.r1), res(pp.r2), int(pp.tlen), int(pp.rescued))
