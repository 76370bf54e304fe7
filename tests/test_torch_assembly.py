"""The port's filter/assembly modules (kit4b_tpu_torch/assembly) against
the JAX package on the same numpy-seeded inputs, exactly (every value is
an integer): `_overlap_pass` (padded batches, Ns in the prefix k-mer,
buckets past `cand`, a `win` that is no multiple of 16), the genome view
built on the device against JAX's host `make_gview`,
`mark_near_duplicates`, `CorpusIndex` probes and containments with their
edge order through appends, kills, consolidation and rebuild, `assemble`,
`filter_assemble`, `merge_pe_to_se`, the greedy selections, `merge_pairs`
and `trim_adapters`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu import dna as jdna
from kit4b_tpu.assembly import assemble as jasm
from kit4b_tpu.assembly import contaminants as jcont
from kit4b_tpu.assembly import filter as jfilt
from kit4b_tpu.assembly import mergepairs as jmp
from kit4b_tpu.assembly import overlap as jov
from kit4b_tpu.assembly import store as jstore
from kit4b_tpu.index.sfx_index import SfxIndex
from kit4b_tpu.io.fasta import SeqRecord as JRec
from kit4b_tpu.ops.extend_packed import pack_genome
from kit4b_tpu.ops.seed_extend_fast import make_gview
from kit4b_tpu_torch import native
from kit4b_tpu_torch.assembly import assemble as pasm
from kit4b_tpu_torch.assembly import contaminants as pcont
from kit4b_tpu_torch.assembly import filter as pfilt
from kit4b_tpu_torch.assembly import mergepairs as pmp
from kit4b_tpu_torch.assembly import overlap as pov
from kit4b_tpu_torch.assembly import store as pstore
from kit4b_tpu_torch.io.fasta import SeqRecord as PRec
from kit4b_tpu_torch.ops.bits import to_words
from kit4b_tpu_torch.ops.seed_extend_fast import make_gview_device

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def lib():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def _source(seed, n=8_000):
    """A random genome with a 12 bp unit 30 times in tandem (buckets past
    any cand) and a few N bases."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[3_000:3_360] = np.tile(rng.integers(0, 4, 12).astype(np.uint8), 30)
    g[rng.choice(n, 12, replace=False)] = jdna.BASE_N
    return g, rng


def _reads(seed, n=300, lens=(40, 91), dups=20, near=20):
    """Reads of seeded lengths from _source, both strands, with exact and
    near duplicates and reads that start on an N."""
    g, rng = _source(seed)
    out = []
    ns = np.nonzero(g == jdna.BASE_N)[0]
    for i in range(n):
        L = int(rng.integers(*lens))
        p = int(ns[i % len(ns)]) - int(rng.integers(0, 4)) if i % 25 == 0 \
            else int(rng.integers(0, len(g) - L))
        r = g[max(p, 0):max(p, 0) + L].copy()
        out.append(jdna.revcomp(r) if i % 3 == 0 else r)
    for i in rng.choice(n, dups):
        out.append(out[i].copy())
    for i in rng.choice(n, near, replace=False):
        r = out[i].copy()
        at = rng.choice(len(r), 1 + i % 3, replace=False)
        r[at] = (r[at] + 1) % 4
        out.append(r)
    return [out[i] for i in rng.permutation(len(out))], rng


def _pe_reads(seed, pairs=200, L=80):
    """Mate-1 and mate-2 arrays of FR pairs (inserts 100-260: some mates
    overlap) from _source, with a tenth duplicated."""
    g, rng = _source(seed)
    a, b = [], []
    for _ in range(pairs):
        ins = int(rng.integers(100, 261))
        p = int(rng.integers(0, len(g) - ins))
        frag = g[p:p + ins]
        a.append(frag[:L].copy())
        b.append(jdna.revcomp(frag[-L:]))
    for i in rng.choice(pairs, pairs // 10):
        a.append(a[i].copy())
        b.append(b[i].copy())
    return a, b, rng


def _stores(arrays, mate=None):
    m = None if mate is None else np.asarray(mate, np.int64)
    return (jstore.SeqStore.from_arrays(arrays, mate=m),
            pstore.SeqStore.from_arrays(arrays, mate=m))


def _pe_stores(a, b):
    j1 = [JRec(f"p{i}", "", x) for i, x in enumerate(a)]
    j2 = [JRec(f"p{i}", "", x) for i, x in enumerate(b)]
    p1 = [PRec(f"p{i}", "", x) for i, x in enumerate(a)]
    p2 = [PRec(f"p{i}", "", x) for i, x in enumerate(b)]
    return (jstore.SeqStore.from_records(j1, j2),
            pstore.SeqStore.from_records(p1, p2))


def _assert_stores_equal(j, p):
    for k in ("seq", "starts", "lengths", "flags"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k),
                                      err_msg=k)
    assert (p.mate is None) == (j.mate is None)
    if j.mate is not None:
        np.testing.assert_array_equal(p.mate, j.mate)


def _pass_inputs(arrays, win):
    js, _ = _stores(arrays)
    g, _ = jov.corpus_genome(js, with_rc=False)
    idx = SfxIndex.build(g)
    nw2 = (win + 15) // 16 + 1
    gpack, gbad = pack_genome(g.seq, nw2 + 1)
    return g, idx, gpack, gbad, nw2


@pytest.mark.parametrize("win,cand,B", [
    (90, 32, 512),      # win the longest read, not a multiple of 16
    (37, 4, 512),       # overlaps cut at win; buckets past cand
    (64, 8, 1024),      # a multiple of 16, more padding
])
def test_overlap_pass_matches(lib, win, cand, B):
    arrays, _ = _reads(11)
    g, idx, gpack, gbad, nw2 = _pass_inputs(arrays, win)
    n = len(g.names)
    assert n < B       # padded batch
    qs = np.zeros(B, np.int64)
    ql = np.zeros(B, np.int64)
    qs[:n], ql[:n] = g.starts, g.lengths
    sa = idx.sa_clean.astype(np.int32)
    lut = idx.lut.astype(np.int32)
    starts = g.starts.astype(np.int32)
    ends = (g.starts + g.lengths).astype(np.int32)
    jp, jm = jov._overlap_pass(
        jnp.asarray(make_gview(gpack, gbad, nw2)), jnp.asarray(g.seq),
        jnp.asarray(sa), jnp.asarray(lut), jnp.asarray(starts),
        jnp.asarray(ends), jnp.asarray(qs), jnp.asarray(ql),
        lut_k=idx.lut_k, cand=cand, win=win)
    t = torch.from_numpy
    pp, pm = pov._overlap_pass(
        make_gview_device(gpack, gbad, nw2, CPU), t(g.seq), t(sa), t(lut),
        t(starts), t(ends), t(qs), t(ql), lut_k=idx.lut_k, cand=cand,
        win=win)
    assert pp.dtype == pm.dtype == torch.int32
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    valid = pp.numpy() != pov.INT32_MAX
    # the cases reach: padded rows empty, full buckets, N prefixes skipped
    assert not valid[n:].any()
    assert (valid[:n].sum(1) == cand).any()
    kb = g.seq[g.starts[:, None] + np.arange(idx.lut_k)]
    n_pref = (kb >= 4).any(1)
    assert n_pref.any() and not valid[:n][n_pref].any()
    assert (pm.numpy()[valid] > 0).any() and (pm.numpy()[valid] == 0).any()


@pytest.mark.parametrize("nw2", [2, 7, 11])
def test_gview_on_device_equals_jax_host_view(nw2):
    rng = np.random.default_rng(nw2)
    seq = rng.integers(0, 6, 3_001).astype(np.uint8)
    gpack, gbad = pack_genome(seq, nw2 + 1)
    want = make_gview(gpack, gbad, nw2)
    got = make_gview_device(gpack, gbad, nw2, CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), to_words(want).numpy())


@pytest.mark.parametrize("max_subs,pe", [(1, False), (2, False), (2, True)])
def test_mark_near_duplicates_matches(lib, max_subs, pe):
    arrays, _ = _reads(12)
    if pe:
        arrays = arrays[:len(arrays) // 2 * 2]
        mate = np.arange(len(arrays)) ^ 1
    else:
        mate = None
    js, ps = _stores(arrays, mate)
    nj = jfilt.mark_near_duplicates(js, max_subs, batch=128)
    np_ = pfilt.mark_near_duplicates(ps, max_subs, batch=128, device="cpu")
    assert nj == np_ > 0
    _assert_stores_equal(js, ps)


def _corpus_pair(arrays):
    return jov.CorpusIndex(list(arrays)), pov.CorpusIndex(list(arrays))


def _assert_corpus_equal(j, p):
    assert p.end == j.end and p.k == j.k
    np.testing.assert_array_equal(p.buf, j.buf)
    assert [c.tolist() for c in p.blocks] == [c.tolist() for c in j.blocks]
    for k in ("c_sid", "c_or", "c_start", "c_len", "alive"):
        assert getattr(p, k) == getattr(j, k), k


def test_corpus_index_probe_and_containments_match():
    arrays, rng = _reads(13)
    j, p = _corpus_pair(arrays)
    n = len(arrays)
    for kw in (dict(min_overlap=20), dict(min_overlap=30,
                                          max_subs_per_100=5)):
        je, jc = j.probe(range(n), **kw)
        pe, pc = p.probe(range(n), **kw)
        assert len(je) > 100 and len(jc) > 10
        np.testing.assert_array_equal(pe, je)     # rows and their order
        np.testing.assert_array_equal(pc, jc)
    # merged products appended; consumed sequences killed; blocks past 24
    # consolidate; a dead share past 75 % rebuilds
    for step in range(30):
        a, b = rng.choice(n, 2, replace=False)
        prod = np.concatenate([arrays[a], arrays[b][10:]])
        sids = [x.append(prod) for x in (j, p)]
        assert sids[0] == sids[1]
        for x in (j, p):
            x.kill(int(a))
            x.flush()
        if step % 5 == 4:
            new = list(range(n, len(j.seqs)))
            np.testing.assert_array_equal(p.containments_in(new),
                                          j.containments_in(new))
            live = j.live_sids()
            assert p.live_sids() == live
            for e_p, e_j in zip(p.probe(live, min_overlap=25),
                                j.probe(live, min_overlap=25)):
                np.testing.assert_array_equal(e_p, e_j)
        _assert_corpus_equal(j, p)
    for s in list(j.live_sids())[: -40]:
        j.kill(s)
        p.kill(s)
    j.flush()
    p.flush()
    assert len(j.blocks) == 1      # the rebuild ran
    _assert_corpus_equal(j, p)
    live = j.live_sids()
    for e_p, e_j in zip(p.probe(live, min_overlap=20),
                        j.probe(live, min_overlap=20)):
        np.testing.assert_array_equal(e_p, e_j)


@pytest.mark.parametrize("pe", [False, True])
def test_assemble_matches(pe):
    if pe:
        a, b, _ = _pe_reads(14)
        js, ps = _pe_stores(a, b)
    else:
        arrays, _ = _reads(14, n=400, lens=(60, 101), dups=30, near=10)
        js, ps = _stores(arrays)
    kw = dict(min_overlap=40, min_overlap_final=25, max_passes=12)
    jlog, plog = [], []
    jo = jasm.assemble(js, jasm.AssembleParams(**kw),
                       progress=lambda *a: jlog.append(a))
    po = pasm.assemble(ps, pasm.AssembleParams(**kw),
                       progress=lambda *a: plog.append(a))
    assert plog == jlog and len(jlog) > 3
    _assert_stores_equal(jo, po)
    assert int(po.lengths.max()) > 300


def test_assemble_checkpoints_match(tmp_path):
    a, b, _ = _pe_reads(15, pairs=120)
    js, ps = _pe_stores(a, b)
    for pkg, st, sub in ((jasm, js, "j"), (pasm, ps, "p")):
        (tmp_path / sub).mkdir()
        pkg.assemble(st, pkg.AssembleParams(
            checkpoint_every=2, checkpoint_path=str(tmp_path / sub / "c"),
            max_passes=6))
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names and names == sorted(f.name for f in
                                     (tmp_path / "p").iterdir())
    for name in names:
        _assert_stores_equal(jstore.SeqStore.load(tmp_path / "j" / name),
                             pstore.SeqStore.load(tmp_path / "p" / name))


def test_filter_assemble_and_artefact_reduce_match(lib):
    a, b, _ = _pe_reads(16, pairs=300)
    a.append(np.random.default_rng(1).integers(0, 4, 80).astype(np.uint8))
    b.append(np.random.default_rng(2).integers(0, 4, 80).astype(np.uint8))
    js, ps = _pe_stores(a, b)
    jt, pt = {}, {}
    jo = jfilt.filter_assemble(js, jfilt.FilterParams(),
                               jasm.AssembleParams(min_overlap=50,
                                                   min_overlap_final=30),
                               timings=jt)
    po = pfilt.filter_assemble(ps, pfilt.FilterParams(),
                               pasm.AssembleParams(min_overlap=50,
                                                   min_overlap_final=30),
                               timings=pt)
    assert pt["n_unsupported"] == jt["n_unsupported"] > 0
    _assert_stores_equal(jo, po)
    js, ps = _pe_stores(a, b)
    fp = dict(near_dup_subs=2, overlap_passes=2, min_overlap_pct=60)
    jlog, plog = [], []
    jo = jfilt.artefact_reduce(js, jfilt.FilterParams(**fp),
                               progress=lambda *x: jlog.append(x))
    po = pfilt.artefact_reduce(ps, pfilt.FilterParams(**fp),
                               progress=lambda *x: plog.append(x),
                               device="cpu")
    assert plog == jlog and jlog[0][1] > 0
    _assert_stores_equal(jo, po)


def test_merge_pe_to_se_and_select_merges_match():
    a, b, rng = _pe_reads(17)
    js, ps = _pe_stores(a, b)
    js.flags[5] |= jstore.FLAG_DELETED      # a pair with one mate gone
    ps.flags[5] |= pstore.FLAG_DELETED
    (jo, jn), (po, pn) = (jasm.merge_pe_to_se(js, min_overlap=20),
                          pasm.merge_pe_to_se(ps, min_overlap=20))
    assert pn == jn > 0
    _assert_stores_equal(jo, po)
    # the per-pass greedy rounds over seeded candidate edges
    n_live = 60
    edges = [(int(x), int(y), int(rng.integers(20, 60)),
              int(rng.integers(0, 3)))
             for x, y in rng.integers(0, 2 * n_live, (200, 2)) if x != y]
    cont = set(rng.choice(n_live, 5).tolist())
    acc = jasm._select_merges(edges, cont, n_live)
    assert pasm._select_merges(edges, cont, n_live) == acc and acc
    arrays, _ = _reads(17, n=n_live, dups=0, near=0)
    js, ps = _stores(arrays)
    live = np.arange(n_live)
    _assert_stores_equal(jasm._apply_merges(js, live, acc, cont, n_live),
                         pasm._apply_merges(ps, live, acc, cont, n_live))
    sid_edges = np.array([[x % n_live, x // n_live, y % n_live, y // n_live,
                           o, m] for x, y, o, m in edges], np.int64)
    alive = [True] * n_live
    alive[3] = False
    assert pasm._select_merges_sid(sid_edges, alive) == \
        jasm._select_merges_sid(sid_edges, alive)


@pytest.mark.parametrize("qual", [False, True])
def test_merge_pairs_matches(qual):
    a, b, rng = _pe_reads(18, L=70)
    q = [rng.integers(2, 41, len(x)).astype(np.uint8) if qual else None
         for x in a + b]
    j1 = [JRec(f"r{i}", "", x, q[i]) for i, x in enumerate(a)]
    j2 = [JRec(f"r{i}", "", x, q[len(a) + i]) for i, x in enumerate(b)]
    p1 = [PRec(f"r{i}", "", x, q[i]) for i, x in enumerate(a)]
    p2 = [PRec(f"r{i}", "", x, q[len(a) + i]) for i, x in enumerate(b)]
    p2[3] = PRec("r3", "", b[3][:50], None if q[0] is None
                 else q[len(a) + 3][:50])       # a second length group
    j2[3] = JRec("r3", "", b[3][:50], p2[3].qual)
    for params in (None, dict(min_overlap=24, max_subs_pct=2)):
        jm, jk, js = jmp.merge_pairs(
            j1, j2, params and jmp.MergeParams(**params))
        pm, pk, ps = pmp.merge_pairs(
            p1, p2, params and pmp.MergeParams(**params))
        assert ps == js and js["merged"] > 0 and js["unmerged"] > 0
        assert [(r.name, r.descr, r.codes.tolist(),
                 None if r.qual is None else r.qual.tolist()) for r in pm] \
            == [(r.name, r.descr, r.codes.tolist(),
                 None if r.qual is None else r.qual.tolist()) for r in jm]
        assert [(x.name, y.name) for x, y in pk] == \
            [(x.name, y.name) for x, y in jk]


@pytest.mark.parametrize("trim5", [False, True])
def test_trim_adapters_matches(trim5):
    rng = np.random.default_rng(19)
    ad = jdna.encode(jcont.DEFAULT_ADAPTERS["TruSeq_R1"])
    nx = jdna.encode(jcont.DEFAULT_ADAPTERS["Nextera"])
    reads = []
    for i in range(60):
        r = rng.integers(0, 4, 70).astype(np.uint8)
        if i % 3 == 0:
            k = int(rng.integers(10, 65))
            r = np.concatenate([r[:k], ad])[:70]
            if i % 2:
                r[k + 3] = (r[k + 3] + 1) % 4          # one adapter error
        elif i % 3 == 1 and i % 2:
            r = np.concatenate([nx[-int(rng.integers(8, 19)):], r])[:70]
        reads.append(r)
    q = [rng.integers(2, 41, 70).astype(np.uint8) for _ in reads]
    jo, jst = jcont.trim_adapters([JRec(f"r{i}", "", r, q[i])
                                   for i, r in enumerate(reads)],
                                  trim5=trim5)
    po, pst = pcont.trim_adapters([PRec(f"r{i}", "", r, q[i])
                                   for i, r in enumerate(reads)],
                                  trim5=trim5)
    assert vars(pst) == vars(jst) and jst.trimmed3 > 10 and jst.dropped
    assert not trim5 or jst.trimmed5 > 0
    assert [(r.name, r.codes.tolist(), r.qual.tolist()) for r in po] == \
        [(r.name, r.codes.tolist(), r.qual.tolist()) for r in jo]
