"""The seeded workload of the parallel golden file and the arrays it holds:
the key-sharded v3, v4 and v5 passes, the position-sharded single-end,
paired-end and deep paired-end passes, `hammings_mesh` and
`hammings_ring`, and `SWService`, each at the mesh shapes of the JAX
package's own tests (tests/test_parallel.py, tests/test_hammings_ring.py).

`kit4b_tpu_torch/data/parallel_golden.npz` holds the JAX package's
answers on this workload, on its 8-device virtual CPU mesh;
`python tests/test_torch_parallel_golden.py` regenerates it where JAX is.
A machine without JAX rebuilds the same inputs with `workload()` (numpy and
the port's own host modules), runs the port with
`compute(port_fns(device), work)` on `[device] * D` and compares with
`differing()`: that is how the port's sharded paths are held to the JAX
package on the card.

The workload (`workload()`):

- "rep": tests/test_parallel.py's repeat-dense genome (100 kbp, seed 23,
  60 copies of a 120 bp unit), 64 reads of 100 bp (seed 5, the first 32
  taken from the repeat), 64 pairs (seed 11) and 32 pairs (seed 13) of
  2 x 100 bp with inserts of 250-450 bp, the last 4 of the 32 replaced by
  exact pairs with a mate across the position shards' boundary at
  ceil(G / 2);
- "pos": its 400 kbp genome (seed 41, 30 copies of a 300 bp unit) and 64
  reads (seed 3);
- "ham": genomes of tests/test_hammings_ring.py and test_parallel.py's
  hammings cases (an N run and leading Ns, an EOS, exact repeats across
  blocks, a genome of 30 bp under K 25), at K 6, 8, 13 and 25, both
  strands and sense only, at D 1, 2, 4 and 8, some at JAX's default
  geometry (T = S = 1024) and the larger ones at T = S = 128, which keeps
  D = 8 small on the CPU; the mesh also in three node partitions;
- "sw": ten seeded (probe, target, diag0) jobs of unequal lengths, some
  with their diagonal at the band's edges, for `SWService.score` at D 1,
  2 and 4 and `SWService.align`.

The file holds each output array under `<group>:<case>:<shape>[:field]`
and the SHA-256 of the inputs.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from .. import dna

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "parallel_golden.npz"
READ_LEN = 100
MESH_SHAPES = ((2, 4), (1, 8), (4, 2))     # (dp, tp) of the SE passes
PE_SHAPES = ((2, 4), (4, 2))               # of the PE and deep passes
FIELDS = ("low_mm", "n_low", "nxt_mm", "hit_id", "hit_mm", "overflow")
HAM_DS = (1, 2, 4, 8)
SW_DS = (1, 2, 4)
SW_BAND = 64
GROUPS = ("key", "pos", "pe", "deep", "mesh", "ring", "sw")
# capacities under which neither the sharded nor the single-device pass
# overflows on these genomes (tests/test_parallel.py's)
SE_CAPS = dict(n_compact=512, n_extend=256, max_ml=5)
PAIR_KW = dict(max_tot=5, mm_delta=2, min_ins=200, max_ins=500)
DEEP_KW = dict(n_blocks=8, block_size=128, skip_bucket=100_000, n_sel=None)


def _genome_of(seq: np.ndarray, n: int):
    from ..io.fasta import Genome
    seq = np.concatenate([seq, [dna.BASE_EOG]]).astype(np.uint8)
    return Genome(["c1"], np.array([0]), np.array([n]), seq)


def repeat_genome():
    """tests/test_parallel.py `setup_repeat`: (genome, index, reads)."""
    from ..index.sfx_index import SfxIndex
    from ..sim import simreads
    rng = np.random.default_rng(23)
    n = 100_000
    seq = rng.integers(0, 4, n).astype(np.uint8)
    unit = seq[500:620]
    for i in range(60):
        seq[2000 + i * 400:2000 + i * 400 + 120] = unit
    g = _genome_of(seq, n)
    idx = SfxIndex.build(g)
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=64, read_len=READ_LEN, seed=5, error_mode="uniform",
        subs_rate=0.02))
    arr = np.stack([r.codes for r in recs])
    for j in range(32):
        p0 = 2000 + (j % 60) * 400 + (j % 20)
        arr[j] = np.where(g.seq[p0:p0 + 100] < 4, g.seq[p0:p0 + 100], 0)
    return g, idx, arr


def pairs(g, n: int, seed: int):
    """tests/test_parallel.py's PE reads: n pairs of 2 x 100 bp."""
    from ..sim import simreads
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=n, read_len=READ_LEN, pe=True, pe_insert_min=250,
        pe_insert_max=450, seed=seed, error_mode="uniform", subs_rate=0.01))
    return np.stack([r.codes for r in r1]), np.stack([r.codes for r in r2])


def boundary_pairs(g, n: int, edge: int):
    """n exact pairs (2 x 100 bp, outer insert 400) whose mate 1 (even i)
    or mate 2 (odd i) has seed windows on both sides of genome position
    `edge`, a position shard's boundary: the deep pass reports such a mate
    twice (ROADMAP.md queue C, 'the position-sharded deep pass reports a
    mate twice at a shard boundary')."""
    r1, r2 = [], []
    for i in range(n):
        p = edge - 40 - 7 * i if i % 2 == 0 else edge - 340 + 7 * i
        fwd = g.seq[p:p + READ_LEN]
        t = g.seq[p + 300:p + 400]
        r1.append(fwd)
        r2.append(np.where(t < 4, 3 - t, t)[::-1])
    return np.stack(r1).astype(np.uint8), np.stack(r2).astype(np.uint8)


def position_genome():
    """tests/test_parallel.py `test_sharded_position_matches_single`'s
    400 kbp genome and reads: (genome, index, reads)."""
    from ..index.sfx_index import SfxIndex
    from ..sim import simreads
    rng = np.random.default_rng(41)
    G = 400_000
    seq = rng.integers(0, 4, G).astype(np.uint8)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for i in range(30):
        seq[4000 + i * 12000:4000 + i * 12000 + 300] = unit
    g = _genome_of(seq, G)
    idx = SfxIndex.build(g)
    recs = simreads.sim_reads(g, simreads.SimParams(
        n_reads=64, read_len=READ_LEN, seed=3, error_mode="uniform",
        subs_rate=0.02))
    return g, idx, np.stack([r.codes for r in recs])


def ring_genome(n: int, seed: int = 7, with_n: bool = True) -> np.ndarray:
    """tests/test_hammings_ring.py `_genome`: an N run at n/3 and 25
    leading Ns."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    if with_n:
        g[n // 3: n // 3 + 40] = dna.BASE_N
        g[:25] = dna.BASE_N
    return g


def hammings_cases() -> list:
    """(name, codes, K, antisense, T, S, D values, node partitions)."""
    eos = np.random.default_rng(15).integers(0, 4, 300).astype(np.uint8)
    eos[150] = dna.BASE_EOS
    sense = np.random.default_rng(16).integers(0, 4, 200).astype(np.uint8)
    rng = np.random.default_rng(3)
    rep = rng.integers(0, 4, 2500).astype(np.uint8)
    unit = rng.integers(0, 4, 200).astype(np.uint8)
    rep[100:300] = unit
    rep[1600:1800] = unit                   # an exact copy across blocks
    nrun = ring_genome(2000)
    return [
        ("nrun13", nrun, 13, True, 128, 128, HAM_DS, 3),
        ("nrun13y", nrun, 13, False, 128, 128, HAM_DS, 1),
        ("repeat8", rep, 8, True, 128, 128, HAM_DS, 1),
        ("eos8", eos, 8, True, 1024, 1024, (1, 2), 1),
        ("sense6", sense, 6, False, 1024, 1024, (1, 2), 1),
        ("sense6s", sense, 6, False, 128, 128, HAM_DS, 1),
        ("tiny25", ring_genome(30, with_n=False), 25, True, 1024, 1024,
         (1, 2), 1),
    ]


def sw_jobs() -> list:
    """(probe, target, diag0) of unequal lengths: mutated copies whose
    true diagonal sits at the band's centre, next to its lower edge and
    next to its upper edge, one with a 10 bp deletion and one with an 8 bp
    insertion, a target cut to half its probe, unrelated pairs, and a band
    that starts past the target's end."""
    rng = np.random.default_rng(1818)

    def rand(n):
        return rng.integers(0, 4, int(n)).astype(np.uint8)

    jobs = []
    for i in range(10):
        p = rand(rng.integers(150, 700))
        if i % 5 == 4:                          # unrelated
            jobs.append((p, rand(rng.integers(100, 900)), 0))
            continue
        lead = int(rng.integers(20, 80))
        copy = p.copy()
        hit = rng.random(len(p)) < 0.03
        copy[hit] = (copy[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        if i == 5:
            copy = np.delete(copy, np.arange(100, 110))     # a deletion
        if i == 7:
            copy = np.insert(copy, 150, rand(8))            # an insertion
        t = np.concatenate([rand(lead), copy, rand(rng.integers(0, 200))])
        # band index of the true diagonal: lead - diag0 + W // 2
        d0 = lead + (0, SW_BAND // 2 - 1, -(SW_BAND // 2 - 1), 0)[i % 5]
        if i == 3:
            t = t[:lead + len(p) // 2]          # target under the probe
        if i == 8:
            d0 = len(t) + 10                    # the band past the target
        jobs.append((p, t, d0))
    return jobs


def workload() -> dict:
    g, idx, reads = repeat_genome()
    pe1, pe2 = pairs(g, 64, 11)
    dp1, dp2 = pairs(g, 32, 13)
    # the last 4 deep pairs straddle the tp 2 and 4 shards' boundary at
    # ceil(G / 2)
    b1, b2 = boundary_pairs(g, 4, -(-len(g.seq) // 2))
    dp1[-4:], dp2[-4:] = b1, b2
    pg, pidx, preads = position_genome()
    return {"rep": dict(genome=g, index=idx, reads=reads, pe1=pe1,
                        pe2=pe2, deep1=dp1, deep2=dp2),
            "pos": dict(genome=pg, index=pidx, reads=preads),
            "ham": hammings_cases(), "sw": sw_jobs()}


def inputs_sha256(work) -> str:
    h = hashlib.sha256()
    for key in ("rep", "pos"):
        d = work[key]
        h.update(d["genome"].seq.tobytes())
        h.update(d["index"].sa_clean.astype(np.int64).tobytes())
        h.update(d["index"].lut.astype(np.int64).tobytes())
        for k in sorted(d):
            if k not in ("genome", "index"):
                h.update(k.encode() + d[k].tobytes())
    for name, codes, *rest in work["ham"]:
        h.update(name.encode() + codes.tobytes() + repr(rest).encode())
    for p, t, d0 in work["sw"]:
        h.update(p.tobytes() + t.tobytes() + str(d0).encode())
    return h.hexdigest()


def se_kw(index) -> dict:
    """The SE passes' arguments on an index (read length 100, 5
    mismatches)."""
    from ..ops.seed_extend_fast import fast_offsets
    return dict(genome_len=len(index.genome.seq),
                offsets=fast_offsets(READ_LEN, index.lut_k, 5),
                lut_k=index.lut_k, **SE_CAPS)


def ops_text(ops: list) -> str:
    return "".join(f"{n}{op}" for op, n in ops)


def compute(fns, work, groups=GROUPS) -> dict:
    """The golden's arrays of `groups` through `fns` (`port_fns(device)`,
    or the JAX package's in tests/torch_parallel_cases.py)."""
    out = {}
    rep, pos = work.get("rep"), work.get("pos")
    if "key" in groups:
        kw = se_kw(rep["index"])
        for ver in ("v3", "v4", "v5"):
            for dp, tp in MESH_SHAPES:
                res = fns.key_pass(ver, dp, tp, rep["index"], rep["reads"],
                                   kw)
                for f in FIELDS:
                    out[f"key:{ver}:{dp}x{tp}:{f}"] = res[f]
    if "pos" in groups:
        kw = se_kw(pos["index"])
        for dp, tp in MESH_SHAPES:
            res = fns.pos_pass(dp, tp, pos["index"], pos["reads"], kw)
            for f in FIELDS:
                out[f"pos:se:{dp}x{tp}:{f}"] = res[f]
    if "pe" in groups:
        kw = dict(se_kw(rep["index"]), **PAIR_KW)
        for dp, tp in PE_SHAPES:
            out[f"pe:rows:{dp}x{tp}"] = fns.pe_pass(
                dp, tp, rep["index"], rep["pe1"], rep["pe2"], kw)
    if "deep" in groups:
        kw = {k: v for k, v in se_kw(rep["index"]).items()
              if k in ("genome_len", "offsets", "lut_k", "max_ml")}
        kw.update(PAIR_KW, **DEEP_KW)
        for dp, tp in PE_SHAPES:
            out[f"deep:rows:{dp}x{tp}"] = fns.deep_pass(
                dp, tp, rep["index"], rep["deep1"], rep["deep2"], kw)
    for engine in ("mesh", "ring"):
        if engine not in groups:
            continue
        for name, codes, K, anti, T, S, Ds, nodes in work["ham"]:
            for D in Ds:
                out[f"{engine}:{name}:D{D}"] = fns.hammings(
                    engine, codes, K, anti, D, T, S, 0, 1)
            if engine == "mesh" and nodes > 1:
                for node in range(nodes):
                    out[f"mesh:{name}:D4:N{node + 1}of{nodes}"] = \
                        fns.hammings("mesh", codes, K, anti, 4, T, S, node,
                                     nodes)
    if "sw" in groups:
        for D in SW_DS:
            out[f"sw:score:D{D}"] = fns.sw_score(work["sw"], SW_BAND, D)
        res = fns.sw_align(work["sw"], SW_BAND)
        out["sw:align:fields"] = np.array(
            [[a.score, a.p_start, a.p_end, a.t_start, a.t_end, a.matches,
              a.mismatches] for a in res], np.int64)
        out["sw:align:ops"] = np.array([ops_text(a.ops) for a in res])
    return out


def differing(out: dict, gold, groups=GROUPS) -> list[str]:
    """Keys of the golden's `groups` that `out` lacks or does not equal
    (shape, dtype and values), and keys of `out` the golden lacks."""
    bad = []
    for k in gold.keys():
        if k.split(":")[0] not in groups:
            continue
        if k not in out:
            bad.append(k)
            continue
        a, b = np.asarray(out[k]), gold[k]
        if not (a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b)):
            bad.append(k)
    bad += [k for k in out if k not in gold.keys()]
    return sorted(set(bad))


class _PortFns:
    """The port's parallel paths on `[device] * D`."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.dev = torch.device(device)

    def _np(self, x):
        return x.cpu().numpy()

    def _gview(self, index):
        from ..ops.extend_packed import pack_genome
        from ..ops.seed_extend_fast import make_gview_device
        gpack, gbad = pack_genome(index.genome.seq, 65)
        return make_gview_device(gpack, gbad, (READ_LEN + 15) // 16 + 1,
                                 self.dev)

    def _mesh(self, dp, tp):
        from ..parallel import mesh as pm
        return pm.make_mesh(dp, tp, [self.dev] * (dp * tp))

    def key_pass(self, ver, dp, tp, index, reads, kw):
        from ..parallel import mesh as pm
        m = self._mesh(dp, tp)
        gview = self._gview(index)
        if ver == "v5":
            _, l4, klo = pm.shard_index_by_key_v5(index.sa_clean, index.lut,
                                                  tp)
            args = pm.device_put_sharded_index_v5(m, gview, l4, klo)
            fn = pm.make_sharded_align_pass_v5(m, read_len=READ_LEN, **kw)
        else:
            args = pm.device_put_sharded_index_v3(
                m, gview, *pm.shard_index_by_key_v3(index.sa_clean,
                                                    index.lut, tp))
            if ver == "v3":
                res = pm.make_sharded_align_pass_v3(m, **kw)(*args, reads)
                return {k: self._np(v) for k, v in res.items()}
            fn = pm.make_sharded_align_pass_v4(m, read_len=READ_LEN, **kw)
        res = fn(*args, *pm.pack_reads_sharded(reads, dp))
        return {k: self._np(v) for k, v in res.items()}

    def _pos_index(self, m, index, tp):
        from ..parallel import mesh as pm
        return pm.device_put_sharded_index_pos(
            m, *pm.shard_index_by_position(index, tp, READ_LEN))

    def pos_pass(self, dp, tp, index, reads, kw):
        from ..parallel import mesh as pm
        m = self._mesh(dp, tp)
        fn = pm.make_sharded_align_pass_pos(m, read_len=READ_LEN, **kw)
        res = fn(*self._pos_index(m, index, tp),
                 *pm.pack_reads_sharded(reads, dp))
        return {k: self._np(v) for k, v in res.items()}

    def _pe(self, make, dp, tp, index, r1, r2, kw):
        from ..parallel import mesh as pm
        m = self._mesh(dp, tp)
        fn = make(m, read_len=READ_LEN, **kw)
        starts = np.asarray(index.genome.starts, np.int32)
        return self._np(fn(*self._pos_index(m, index, tp), starts,
                           *pm.pack_reads_sharded(r1, dp),
                           *pm.pack_reads_sharded(r2, dp)))

    def pe_pass(self, dp, tp, index, r1, r2, kw):
        from ..parallel import mesh as pm
        return self._pe(pm.make_sharded_pe_pass_pos, dp, tp, index, r1, r2,
                        kw)

    def deep_pass(self, dp, tp, index, r1, r2, kw):
        from ..parallel import mesh as pm
        return self._pe(pm.make_sharded_deep_pe_pass_pos, dp, tp, index,
                        r1, r2, kw)

    def hammings(self, engine, codes, K, antisense, D, T, S, node,
                 numnodes):
        devs = [self.dev] * D
        if engine == "ring":
            from ..parallel.hammings_ring import hammings_ring
            return hammings_ring(codes, K, antisense=antisense,
                                 devices=devs, T=T, S=S)
        from ..parallel.hammings_mesh import hammings_mesh
        return hammings_mesh(codes, K, antisense=antisense, devices=devs,
                             node=node, numnodes=numnodes, T=T, S=S)

    def _jobs(self, jobs):
        from ..parallel.swservice import SWJob
        return [SWJob(p, t, d0) for p, t, d0 in jobs]

    def sw_score(self, jobs, band, D):
        from ..parallel.swservice import SWService
        return SWService(band=band, devices=[self.dev] * D).score(
            self._jobs(jobs))

    def sw_align(self, jobs, band):
        from ..parallel.swservice import SWService
        return SWService(band=band, devices=[self.dev]).align(
            self._jobs(jobs))


def port_fns(device) -> _PortFns:
    """The port's callables of `compute()` on `[device] * D`."""
    return _PortFns(device)
