"""The port's dp x tp mesh (kit4b_tpu_torch/parallel/mesh.py) against the
JAX package's (kit4b_tpu/parallel/mesh.py), exactly: the key- and
position-sharded index builders array by array at tp 1, 2, 4 and 8 (and
on a genome where shards own no suffix); the key-sharded v3, v4 and v5
passes and the position-sharded single-end, paired-end and deep
paired-end passes on `[cpu] * D` against JAX's on its 8-device virtual
CPU mesh, against the committed golden, and against the port's own
single-device passes; `pack_reads_sharded`'s N-list fault and the deep
pass's boundary fault, which both packages share; and the refusal of
genomes past the int32 locus-id ceiling. JAX's outputs come from one
`make_parallel_golden.compute` per module (each mesh shape costs a
compile)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kit4b_tpu.ops import seed_extend_v4 as jv4
from kit4b_tpu.parallel import mesh as jm
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align.kalign import pack_reads_2bit
from kit4b_tpu_torch.ops import pe_packed, seed_extend_deep, \
    seed_extend_fast as pfast, seed_extend_v3, seed_extend_v4, \
    seed_extend_v5
from kit4b_tpu_torch.ops.extend_packed import pack_genome
from kit4b_tpu_torch.parallel import mesh as pm
from kit4b_tpu_torch.tools import make_parallel_golden as mg
from torch_parallel_cases import jax_fns

CPU = torch.device("cpu")
GROUPS = ("key", "pos", "pe", "deep")
L = mg.READ_LEN


@pytest.fixture(scope="module")
def work():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    return mg.workload()


@pytest.fixture(scope="module")
def jax_out(work):
    return mg.compute(jax_fns(), work, groups=GROUPS)


@pytest.fixture(scope="module")
def port_out(work):
    return mg.compute(mg.port_fns("cpu"), work, groups=GROUPS)


@pytest.fixture(scope="module")
def golden():
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _cases():
    out = [("key", v, s) for v in ("v3", "v4", "v5") for s in mg.MESH_SHAPES]
    out += [("pos", "se", s) for s in mg.MESH_SHAPES]
    out += [(g, "rows", s) for g in ("pe", "deep") for s in mg.PE_SHAPES]
    return out


def _keys(out, group, case, shape):
    pre = f"{group}:{case}:{shape[0]}x{shape[1]}"
    return sorted(k for k in out if k == pre or k.startswith(pre + ":"))


@pytest.mark.parametrize("group,case,shape", _cases())
def test_sharded_pass_matches_jax_and_golden(jax_out, port_out, golden,
                                             group, case, shape):
    keys = _keys(golden, group, case, shape)
    assert keys and keys == _keys(port_out, group, case, shape)
    for k in keys:
        assert jax_out[k].dtype == golden[k].dtype, k
        np.testing.assert_array_equal(jax_out[k], golden[k], err_msg=k)
        assert port_out[k].dtype == golden[k].dtype, k
        np.testing.assert_array_equal(port_out[k], golden[k], err_msg=k)


# --- the port's single-device passes ------------------------------------

def _tables(index):
    gpack, gbad = pack_genome(index.genome.seq, 65)
    gview = pfast.make_gview_device(gpack, gbad, (L + 15) // 16 + 1, CPU)
    sa = torch.from_numpy(index.sa_clean.astype(np.int32))
    lut = torch.from_numpy(index.lut.astype(np.int32))
    return gview, sa, lut, seed_extend_v3.make_lut2_device(lut)


def _packed(reads):
    return tuple(torch.from_numpy(a) for a in pack_reads_2bit(reads))


def _single(work, group, case):
    """The single-device pass the sharded one must equal."""
    src = work["pos"] if group == "pos" else work["rep"]
    index = src["index"]
    gview, sa, lut, lut2 = _tables(index)
    kw = mg.se_kw(index)
    if group in ("key", "pos") and case != "v5":
        res = seed_extend_v3.fast_pass_v3(gview, sa, lut2,
                                          *_packed(src["reads"]),
                                          read_len=L, **kw)
        return {k: v.numpy() for k, v in res.items()}
    if case == "v5":
        lut4 = seed_extend_v5.make_lut4_device(lut, sa)
        planes = seed_extend_v4.words_from_2bit(*_packed(src["reads"]), L)
        ids, mm, ovf = seed_extend_v5._cands_core_v5(
            gview, lut4, planes, read_len=L,
            **{k: v for k, v in kw.items() if k != "max_ml"})
        res = pfast.finalize_fast(ids.T, mm.T, max_ml=kw["max_ml"])
        res["overflow"] = ovf
        return {k: v.numpy() for k, v in res.items()}
    starts = torch.from_numpy(np.asarray(index.genome.starts, np.int32))
    if group == "pe":
        rows = pe_packed.pe_pass_packed(
            gview, sa, lut2, starts, *_packed(src["pe1"]),
            *_packed(src["pe2"]), read_len=L, tier2=None, tier3=None,
            **kw, **mg.PAIR_KW)
        return pe_packed.unpack_rows12(rows.numpy())
    dkw = dict(genome_len=kw["genome_len"], offsets=kw["offsets"],
               lut_k=kw["lut_k"], read_len=L, **mg.DEEP_KW)
    fs = []
    for r in (src["deep1"], src["deep2"]):
        planes = seed_extend_v4.words_from_2bit(*_packed(r), L)
        ids, mm = seed_extend_deep.deep_cands_planes(gview, sa, lut2, planes,
                                                     **dkw)
        fs.append(pfast.finalize_fast(ids.T, mm.T, max_ml=kw["max_ml"]))
    no = torch.zeros(src["deep1"].shape[0], dtype=torch.bool)
    return pe_packed._pair_rows(fs[0], fs[1], no, no, starts, L1=L, L2=L,
                                **mg.PAIR_KW).numpy()


@pytest.mark.parametrize("group,case,shape", _cases())
def test_sharded_pass_matches_the_single_device_pass(work, port_out, group,
                                                     case, shape):
    want = _single(work, group, case)
    pre = f"{group}:{case}:{shape[0]}x{shape[1]}"
    if isinstance(want, dict):
        # capacities do not bind (v5 flags its bucket-high reads)
        assert case == "v5" or not want["overflow"].any()
        if group == "key":
            # the repeat reads are rediscovered by several windows
            assert (want["n_low"][:32] > 1).any()
        for f in mg.FIELDS:
            np.testing.assert_array_equal(port_out[f"{pre}:{f}"], want[f],
                                          err_msg=f)
    elif group == "deep":
        # the last 4 pairs straddle the shard boundary (the next test)
        np.testing.assert_array_equal(port_out[pre][:-4], want[:-4])
    else:
        np.testing.assert_array_equal(port_out[pre], want)


@pytest.mark.parametrize("shape", mg.PE_SHAPES)
def test_deep_pass_reports_a_boundary_mate_twice(work, golden, port_out,
                                                 shape):
    """JAX's fault, which the port copies (ROADMAP.md queue C): a shard
    explores only the seed windows whose buckets hold entries in its own
    block, so a mate whose windows straddle a shard boundary finds a
    first exact window in each shard and is reported by both. Its side
    code becomes -2 (multi) where one device reports its locus; nothing
    else in the row changes."""
    want = _single(work, "deep", "rows")
    edge = -(-len(work["rep"]["genome"].seq) // 2)
    key = f"deep:rows:{shape[0]}x{shape[1]}"
    for got in (golden[key], port_out[key]):
        rows, cols = np.nonzero(got != want)
        assert sorted(set(rows.tolist())) == [29, 30, 31]
        assert ((cols == 6) | (cols == 7)).all()
        assert (got[rows, cols] == -2).all()
        assert (np.abs((want[rows, cols] >> 1) - edge) < 2 * L).all()


# --- the index builders -----------------------------------------------------

def _skewed_index():
    """A genome of 2,000 As with a few Cs: at tp 8 most key ranges own no
    suffix."""
    from kit4b_tpu_torch.index.sfx_index import SfxIndex
    seq = np.zeros(2000, np.uint8)
    seq[::97] = 1
    return SfxIndex.build(mg._genome_of(seq, 2000))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("builder", ["key", "key_v3", "key_v5", "position"])
def test_index_builders_match_jax(work, builder, tp):
    for index in (work["rep"]["index"], _skewed_index()):
        if builder == "position":
            got = pm.shard_index_by_position(index, tp, L)
            want = jm.shard_index_by_position(index, tp, L)
        else:
            fn = {"key": "shard_index_by_key", "key_v3":
                  "shard_index_by_key_v3", "key_v5":
                  "shard_index_by_key_v5"}[builder]
            got = getattr(pm, fn)(index.sa_clean, index.lut, tp)
            want = getattr(jm, fn)(index.sa_clean, index.lut, tp)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_skewed_genome_has_shards_that_own_no_suffix():
    index = _skewed_index()
    _, lut_shards, _ = pm.shard_index_by_key(index.sa_clean, index.lut, 8)
    owned = lut_shards[:, -1]
    assert (owned == 0).sum() >= 4 and owned.sum() == len(index.sa_clean)
    _, l4, _ = pm.shard_index_by_key_v5(index.sa_clean, index.lut, 8)
    assert not l4[owned == 0].any()


# --- pack_reads_sharded's N lists (ROADMAP.md queue C) ----------------------

def _n_reads(n_a: int, n_b: int):
    """128 reads of 100 bp: shard 0 (reads 0-63) holds n_a Ns, shard 1
    (reads 64-127) n_b, the same number in each of a shard's reads."""
    rng = np.random.default_rng(99)
    reads = rng.integers(0, 4, (128, L)).astype(np.uint8)
    for lo, n in ((0, n_a), (64, n_b)):
        c = np.arange(n)
        reads[lo + c // (n // 64), c % (n // 64)] = 4
    return reads


def _planes_jax(reads2b, nlist, dp):
    """words_from_2bit under shard_map, the blocks cut as P("dp", None)."""
    m = jax.sharding.Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    fn = jax.jit(jax.shard_map(
        lambda r, n: jv4.words_from_2bit(r, n, L), mesh=m,
        in_specs=(P("dp", None), P("dp", None)),
        out_specs=(P(None, "dp"),) * 4, check_vma=False))
    return [np.asarray(x).astype(np.int64)
            for x in fn(jnp.asarray(reads2b), jnp.asarray(nlist))]


def _planes_port(reads2b, nlist, dp):
    m = pm.make_mesh(dp, 1, [CPU] * dp)
    r, n = pm.device_put(m, reads2b, ("dp",)), pm.device_put(m, nlist,
                                                             ("dp",))
    parts = [seed_extend_v4.words_from_2bit(r.local(d, 0), n.local(d, 0), L)
             for d in range(dp)]
    return [torch.cat([p[i] for p in parts], dim=1).numpy()
            for i in range(4)]


def _planes_per_shard(reads, dp):
    per = reads.shape[0] // dp
    parts = [seed_extend_v4.words_from_2bit(
        *_packed(reads[d * per:(d + 1) * per]), L) for d in range(dp)]
    return [torch.cat([p[i] for p in parts], dim=1).numpy()
            for i in range(4)]


def _wrong_reads(got, want):
    """Read indices whose word planes differ."""
    return sorted({int(b) for g, w in zip(got, want)
                   for b in np.nonzero((g != w).any(0))[0]})


@pytest.mark.parametrize("n_a,n_b,wrong", [
    (64, 4224, list(range(32)) + list(range(64, 96))),   # the fault
    (4224, 64, []),          # the longer list first: each block is its own
    (64, 128, []),           # lists of one length
    (4224, 4224, []),
])
def test_pack_reads_sharded_n_lists(work, n_a, n_b, wrong):
    reads = _n_reads(n_a, n_b)
    r2b, nl = pm.pack_reads_sharded(reads, 2)
    jr2b, jnl = jm.pack_reads_sharded(reads, 2)
    np.testing.assert_array_equal(r2b, jr2b)
    np.testing.assert_array_equal(nl, jnl)
    got = _planes_port(r2b, nl, 2)
    for a, b in zip(got, _planes_jax(jr2b, jnl, 2)):
        np.testing.assert_array_equal(a, b)
    assert _wrong_reads(got, _planes_per_shard(reads, 2)) == wrong


# --- the refusals ------------------------------------------------------------

@pytest.mark.parametrize("factory", [
    "make_sharded_align_pass_v3", "make_sharded_align_pass_v4",
    "make_sharded_align_pass_v5", "make_sharded_align_pass_pos",
    "make_sharded_pe_pass_pos", "make_sharded_deep_pe_pass_pos"])
def test_genomes_past_the_ceiling_are_refused(factory):
    m = pm.make_mesh(1, 1, [CPU])
    kw = dict(genome_len=2 ** 30, offsets=(0,), lut_k=12, read_len=100,
              n_compact=24, n_extend=12, max_ml=5, max_tot=5, mm_delta=2,
              min_ins=200, max_ins=500, n_blocks=8, block_size=128)
    fn = getattr(pm, factory)
    names = fn.__code__.co_varnames[1:fn.__code__.co_argcount
                                    + fn.__code__.co_kwonlyargcount]
    with pytest.raises(NotImplementedError, match="item 18"):
        fn(m, **{k: v for k, v in kw.items() if k in names})
    kw["genome_len"] = 2 ** 30 - 1           # 2*G+1 = 2^31 - 1 passes
    fn(m, **{k: v for k, v in kw.items() if k in names})


# --- the mesh and its collectives --------------------------------------------

def test_make_mesh_and_placement():
    m = pm.make_mesh(2, 4, [CPU] * 8)
    assert m.devices.shape == (2, 4) and m.shape == {"dp": 2, "tp": 4}
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        pm.make_mesh(3, 3, [CPU] * 8)
    x = torch.arange(16).reshape(8, 2)
    s = pm.device_put(m, x, ("tp",))
    assert [s.local(1, t)[0, 0].item() for t in range(4)] == [0, 4, 8, 12]
    s = pm.device_put(m, x, ("dp",))
    assert s.local(1, 3).shape == (4, 2) and s.local(1, 3)[0, 0] == 8
    assert pm.device_put(m, x).local(1, 2) is x
    with pytest.raises(ValueError, match="equal blocks"):
        pm.device_put(m, torch.zeros(6), ("tp",))
    blocks = [torch.full((2,), i) for i in range(4)]
    assert pm.all_gather(blocks, CPU).tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    flags = [torch.tensor([True, False]), torch.tensor([False, False])]
    assert (pm.psum(flags, CPU) > 0).tolist() == [True, False]


def test_default_devices_need_cuda(monkeypatch):
    from kit4b_tpu_torch.device import DeviceUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        pm.make_mesh(1, 1)
