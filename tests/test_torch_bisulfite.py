"""Bisulfite alignment in the port (kit4b_tpu_torch/align/bisulfite.py)
against the JAX package, bit for bit: the collapse maps, the two collapsed
indexes (radix-3 LUTs through `digit_map`) and their .kbx file loaded by
either package, `fast_candidates` with `single_strand`, `lut_base` and
`digit_map` slot by slot, `BsAligner.align_batch_raw`, and the CLI (`index
-m 1`, `kalign --bisulfite`). Then the JAX package's findings, which the
port keeps (ROADMAP.md queue C): no host ladder, so a read whose seeds
fill more than n_compact = 24 slots is -3 (multi) while one that fills
exactly 24 is placed; and the genome view built for the first read length,
so a batch of another word count raises (TypeError in JAX, a ValueError
naming the finding in the port) at exactly the same lengths, while reads
of one word after longer ones go on in both with the same answers."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kit4b_tpu import dna as jdna
from kit4b_tpu.align import bisulfite as jb
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.io.fasta import Genome as JGenome
from kit4b_tpu.ops import seed_extend_fast as jF
from kit4b_tpu.ops.extend_packed import pack_genome as jpack
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import bisulfite as pb
from kit4b_tpu_torch.align.kalign import build_pass_schedule
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord, write_fasta
from kit4b_tpu_torch.ops import seed_extend_fast as pF
from kit4b_tpu_torch.ops.extend_packed import pack_genome
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
from test_bisulfite import _bis_convert
from test_torch_kmarkers_card import few_threads  # noqa: F401

N = 60_000


@pytest.fixture(scope="module")
def indexes():
    """(port BsIndex, JAX BsIndex) of a 60 kbp random genome with a 300 bp
    unit planted twice and a 200 bp unit three times (lut_k 11)."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    rng = np.random.default_rng(17)
    s = rng.integers(0, 4, N).astype(np.uint8)
    for n, at in ((300, (5_000, 25_000)), (200, (40_000, 45_000, 50_000))):
        u = rng.integers(0, 4, n).astype(np.uint8)
        for p in at:
            s[p:p + n] = u
    seq = np.append(s, jdna.BASE_EOG).astype(np.uint8)
    args = (["c1"], np.array([0]), np.array([N]), seq)
    pi, ji = pb.BsIndex.build(Genome(*args)), jb.BsIndex.build(JGenome(*args))
    assert pi.lut_k == ji.lut_k == 11
    return pi, ji


def _reads(seq, L, n, seed, lo=0, hi=N):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(lo, hi - L))
        out.append(_bis_convert(seq[p:p + L], int(rng.integers(0, 2)), rng))
    return np.stack(out)


def test_collapse_maps_match():
    x = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(pb.collapse_ct(x), jb.collapse_ct(x))
    np.testing.assert_array_equal(pb.collapse_ga(x), jb.collapse_ga(x))
    assert pb.BsIndex.DMAP_CT == jb.BsIndex.DMAP_CT
    assert pb.BsIndex.DMAP_GA == jb.BsIndex.DMAP_GA


def test_bis_convert_is_the_tests_rule():
    seq = np.random.default_rng(4).integers(0, 4, 500).astype(np.uint8)
    for strand in (0, 1):
        a = mg.bis_convert(seq, strand, np.random.default_rng(9))
        b = _bis_convert(seq, strand, np.random.default_rng(9))
        np.testing.assert_array_equal(a, b)


def test_indexes_match(indexes):
    pi, ji = indexes
    for a, b in ((pi.ct, ji.ct), (pi.ga, ji.ga)):
        np.testing.assert_array_equal(a.sa_clean, b.sa_clean)
        np.testing.assert_array_equal(a.lut, b.lut)
        np.testing.assert_array_equal(a.genome.seq, b.genome.seq)
        assert (a.lut_base, a.digit_map) == (b.lut_base, b.digit_map)
    assert len(pi.ct.lut) == 3 ** 11 + 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kbx_loads_in_either_package(tmp_path, indexes, writer):
    pi, ji = indexes
    (ji if writer == "jax" else pi).save(tmp_path / "g.kbx")
    for mod in (jb, pb):
        got = mod.BsIndex.load(tmp_path / "g.kbx")
        assert got.lut_k == pi.lut_k and got.genome.names == ["c1"]
        np.testing.assert_array_equal(got.genome.seq, pi.genome.seq)
        for a, b in ((got.ct, pi.ct), (got.ga, pi.ga)):
            np.testing.assert_array_equal(a.sa_clean, b.sa_clean)
            np.testing.assert_array_equal(a.lut, b.lut)
            np.testing.assert_array_equal(a.genome.seq, b.genome.seq)
            assert a.digit_map == b.digit_map and a.lut_base == 3


@pytest.mark.parametrize("L,strand,nc", [(100, 0, 24), (100, 1, 24),
                                         (150, 0, 24), (64, 1, 8)])
def test_fast_candidates_one_strand_radix3_matches_jax(indexes, L, strand,
                                                       nc):
    pi, ji = indexes
    idx = pi.ct if strand == 0 else pi.ga
    dmap = pb.BsIndex.DMAP_CT if strand == 0 else pb.BsIndex.DMAP_GA
    reads = _reads(pi.genome.seq, L, 96, L + strand)
    coll = pb.collapse_ct(reads) if strand == 0 else \
        pb.collapse_ga(np.stack([jdna.revcomp(r) for r in reads]))
    coll[5, 7] = jdna.BASE_N                       # a seed with an N
    nw2 = (L + 15) // 16 + 1
    _, mtm = build_pass_schedule(L, 5, 1, len(idx.genome.seq))
    kw = dict(genome_len=len(idx.genome.seq),
              offsets=pF.fast_offsets(L, idx.lut_k, mtm), lut_k=idx.lut_k,
              n_compact=nc, single_strand=strand, lut_base=3, digit_map=dmap)
    gp, gb = pack_genome(idx.genome.seq, 65)
    got = pF.fast_candidates(
        pF.make_gview_device(gp, gb, nw2, torch.device("cpu")),
        torch.from_numpy(idx.sa_clean.astype(np.int32)),
        torch.from_numpy(idx.lut.astype(np.int32)),
        torch.from_numpy(coll), **kw)
    jgp, jgb = jpack(idx.genome.seq, 65)
    want = jF.fast_candidates(
        jnp.asarray(jF.make_gview(jgp, jgb, nw2)),
        jnp.asarray(idx.sa_clean.astype(np.int32)),
        jnp.asarray(idx.lut.astype(np.int32)), jnp.int32(0),
        jnp.asarray(coll), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = got[0].numpy()
    ok = ids != pF.INT32_MAX
    assert ok.any() and ((ids[ok] & 1) == strand).all()
    if nc == 8:
        assert got[2].any()          # overflowing reads, flagged alike


@pytest.mark.parametrize("L", [50, 100])
def test_align_batch_raw_matches_jax(indexes, L):
    pi, ji = indexes
    reads = _reads(pi.genome.seq, L, 128, 3 * L)
    reads[0, 10:14] = jdna.BASE_N                  # excess Ns
    got = pb.BsAligner(pi, batch_size=128, device="cpu").align_batch_raw(
        reads)
    want = jb.BsAligner(ji, batch_size=128).align_batch_raw(reads)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["nar"] == 0).mean() > 0.8 and got["nar"][0] == 3
    assert (got["strand"][got["nar"] == 0] == 1).any()


def _slot_totals(idx, reads, dmap, L):
    """Per read, the seeds' bucket entries in total (the slots the pass
    must fill), computed here from the index without the pass."""
    _, mtm = build_pass_schedule(L, 5, 1, len(idx.genome.seq))
    offs = pF.fast_offsets(L, idx.lut_k, mtm)
    dm = np.asarray(dmap)
    pw = 3 ** np.arange(idx.lut_k - 1, -1, -1)
    tot = np.zeros(len(reads), np.int64)
    for o in offs:
        b = reads[:, o:o + idx.lut_k]
        key = (dm[np.minimum(b, 3)] * pw).sum(1)
        cnt = idx.lut[key + 1] - idx.lut[key]
        tot += np.where((b < 4).all(1), cnt, 0)
    return tot


def test_overflow_at_25_slots_and_not_at_24(indexes):
    """No host ladder: a read whose seeds fill 25 slots comes back -3 and
    is classified multi; one that fills exactly 24 is placed. Reads from
    the planted units, where buckets hold several entries."""
    pi, ji = indexes
    cand = np.concatenate([
        _reads(pi.genome.seq, 150, 1500, 5, 4_900, 5_450),
        _reads(pi.genome.seq, 150, 1500, 6, 39_900, 50_350)])
    ct = _slot_totals(pi.ct, pb.collapse_ct(cand), pb.BsIndex.DMAP_CT, 150)
    ga = _slot_totals(pi.ga, pb.collapse_ga(
        np.stack([jdna.revcomp(r) for r in cand])), pb.BsIndex.DMAP_GA, 150)
    top = np.maximum(ct, ga)
    pick = [np.nonzero(top == t)[0][:8] for t in (24, 25)]
    assert all(len(p) for p in pick), np.bincount(top)
    reads = cand[np.concatenate(pick)]
    pa = pb.BsAligner(pi, batch_size=len(reads), device="cpu")
    got = pa.align_batch_raw(reads)
    want = jb.BsAligner(ji, batch_size=len(reads)).align_batch_raw(reads)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n24 = len(pick[0])
    assert (got["nar"][n24:] == 2).all()           # -3: multi
    # the pass's own codes: -3 for every read at 25 slots, none at 24
    (gct, sct, lct), (gga, sga, lga) = pa._device(150)
    r = torch.from_numpy(reads)
    rc = pF.revcomp_device(r)
    _, mtm = build_pass_schedule(150, 5, 1, len(pi.genome.seq))
    code = pb.bs_pass_compact(
        gct, sct, lct, gga, sga, lga, torch.where(r == 1, 3, r),
        torch.where(rc == 2, 0, rc), genome_len=len(pi.genome.seq),
        offsets=pF.fast_offsets(150, pi.lut_k, mtm), lut_k=pi.lut_k,
        n_compact=24, max_tot_mm=mtm, mm_delta=1)[:, 0].numpy()
    assert (code[n24:] == -3).all() and (code[:n24] != -3).all()


def test_150bp_reads_overflow_as_in_jax(indexes):
    """Exact fully-converted 150 bp reads over the whole genome: some come
    back -3 (multi) with a single best locus, in both packages."""
    pi, ji = indexes
    rng = np.random.default_rng(1)
    reads = []
    for _ in range(64):
        p = int(rng.integers(0, N - 150))
        s = int(rng.integers(0, 2))
        r = pi.genome.seq[p:p + 150] if s == 0 else \
            jdna.revcomp(pi.genome.seq[p:p + 150])
        reads.append(pb.collapse_ct(r))
    reads = np.stack(reads)
    got = pb.BsAligner(pi, batch_size=64, device="cpu").align_batch_raw(
        reads)
    want = jb.BsAligner(ji, batch_size=64).align_batch_raw(reads)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ovf = (got["nar"] == 2) & (got["n_low"] == 1) & (got["mm"] == 0)
    assert ovf.any()


@pytest.mark.parametrize("first,then", [
    (32, 17), (32, 33), (33, 48), (48, 49), (100, 16), (100, 11), (16, 17),
    (150, 50), (50, 150), (64, 49), (65, 64)])
def test_mixed_lengths_refused_where_jax_raises(indexes, first, then):
    pi, ji = indexes
    r1 = _reads(pi.genome.seq, first, 16, first)
    r2 = _reads(pi.genome.seq, then, 16, 1000 + then)
    pa = pb.BsAligner(pi, batch_size=16, device="cpu")
    ja = jb.BsAligner(ji, batch_size=16)
    pa.align_batch_raw(r1)
    ja.align_batch_raw(r1)
    try:
        want = ja.align_batch_raw(r2)
    except TypeError as e:
        assert "incompatible shapes" in str(e)
        with pytest.raises(ValueError, match="queue C"):
            pa.align_batch_raw(r2)
        assert math.ceil(first / 16) != math.ceil(then / 16)
        return
    got = pa.align_batch_raw(r2)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert math.ceil(first / 16) == math.ceil(then / 16) or then <= 16


def test_cli_index_and_kalign_bisulfite_match_jax(tmp_path):
    g, _, bis, _, _, _ = mg.workload()
    fa = tmp_path / "g.fa"
    write_fasta(fa, [SeqRecord(g.names[i], "", g.chrom_codes(i))
                     for i in range(g.nchroms())])
    reads = tmp_path / "bis.fa"
    rng = np.random.default_rng(3)
    recs = list(bis[:70])
    for r in recs[::5]:
        r.qual = rng.integers(2, 41, len(r.codes)).astype(np.uint8)
    from kit4b_tpu_torch.io.fasta import write_fastq
    write_fastq(reads, recs)
    outs = {}
    for tag, main, extra in (("jax", jax_main, []),
                             ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        assert main(["index", "-m", "1", "-i", str(fa), "-o",
                     str(d / "g.kbx")]) == 0
        # a short last batch padded by its first read; -M 1
        assert main(["kalign", "--bisulfite", "-i", str(reads), "-I",
                     str(d / "g.kbx"), "-o", str(d / "o.sam"), "-b", "64",
                     "-M", "1", "-s", "4"] + extra) == 0
        with np.load(d / "g.kbx.npz", allow_pickle=True) as z:
            outs[tag] = {k: z[k].tobytes() for k in z.files
                         if k != "chrom_names"}
        outs[tag]["sam"] = (d / "o.sam").read_bytes()
    assert outs["port"] == outs["jax"]
    body = [ln.split(b"\t") for ln in outs["port"]["sam"].splitlines()
            if not ln.startswith(b"@")]
    assert len(body) == 70
    acc = [c for c in body if not int(c[1]) & 4]
    assert acc and all(c[4] == b"254" and c[-1] == b"XB:A:B" for c in acc)
