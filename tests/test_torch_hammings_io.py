"""The numpy helpers that the port re-homes from kit4b_tpu/kmer/hammings.py
(whose module imports jax): oracle, merge, and the .csv/.hmg/.npy readers
and writers must give byte-identical files and equal arrays."""
import numpy as np
import pytest

from kit4b_tpu.io.fasta import Genome, SeqRecord
from kit4b_tpu.kmer import hammings as jh
from kit4b_tpu_torch.kmer import hammings as th


def _genome():
    rng = np.random.default_rng(17)
    return Genome.from_records([
        SeqRecord("cA", "", rng.integers(0, 5, 230).astype(np.uint8)),
        SeqRecord("cB", "", rng.integers(0, 4, 140).astype(np.uint8)),
        SeqRecord("cC", "", rng.integers(0, 4, 6).astype(np.uint8))])


def _dists(seed, n=None):
    """Per-chrom uint16 distances with BIG holes, shaped like _genome's
    chromosomes at K = 9."""
    rng = np.random.default_rng(seed)
    out = []
    for ln in n or (222, 132, 0):
        d = rng.integers(0, 9, ln).astype(np.uint16)
        d[rng.random(ln) < 0.1] = th.BIG
        out.append(d)
    return out


@pytest.mark.parametrize("anti", [True, False])
@pytest.mark.parametrize("K", [5, 9])
def test_oracle_is_identical(K, anti):
    g = _genome().seq[200:]     # N bases, two EOS and the EOG
    a = th.hammings_oracle(g, K, antisense=anti)
    b = jh.hammings_oracle(g, K, antisense=anti)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_merge_is_identical():
    parts = [np.concatenate(_dists(s)) for s in (1, 2, 3)]
    assert th.merge(*parts).tobytes() == jh.merge(*parts).tobytes()
    with pytest.raises(ValueError):
        th.merge(parts[0], parts[1][:-1])


def test_split_and_writers_give_identical_files(tmp_path):
    g = _genome()
    K = 9
    hmin = np.random.default_rng(5).integers(
        0, 10, len(g.seq)).astype(np.uint16)
    names_t, dists_t = th.split_by_chrom(g, hmin, K)
    names_j, dists_j = jh.split_by_chrom(g, hmin, K)
    assert names_t == names_j
    for a, b in zip(dists_t, dists_j):
        assert a.tobytes() == b.tobytes()
    th.write_csv(tmp_path / "t.csv", g, hmin, K)
    jh.write_csv(tmp_path / "j.csv", g, hmin, K)
    th.write_hmg(tmp_path / "t.hmg", names_t, dists_t)
    jh.write_hmg(tmp_path / "j.hmg", names_j, dists_j)
    for ext in ("csv", "hmg"):
        assert (tmp_path / f"t.{ext}").read_bytes() \
            == (tmp_path / f"j.{ext}").read_bytes()


@pytest.mark.parametrize("ext", ["hmg", "csv", "npy"])
def test_save_and_load_dists_are_identical(tmp_path, ext):
    names, dists = ["cA", "cB", "cC"], _dists(8)
    th.save_dists(tmp_path / f"t.{ext}", names, dists)
    jh.save_dists(tmp_path / f"j.{ext}", names, dists)
    assert (tmp_path / f"t.{ext}").read_bytes() \
        == (tmp_path / f"j.{ext}").read_bytes()
    nt, dt = th.load_dists(tmp_path / f"t.{ext}")
    nj, dj = jh.load_dists(tmp_path / f"j.{ext}")
    assert nt == nj and len(dt) == len(dj)
    for a, b in zip(dt, dj):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_merge_dists_and_trans_are_identical(tmp_path):
    names = ["cA", "cB", "cC"]
    loaded = []
    for s in (3, 4, 5):
        jh.write_hmg(tmp_path / f"n{s}.hmg", names, _dists(s))
        loaded.append(th.load_dists(tmp_path / f"n{s}.hmg"))
    nt, dt = th.merge_dists(loaded)
    nj, dj = jh.merge_dists(loaded)
    assert nt == nj == names
    for a, b in zip(dt, dj):
        assert a.tobytes() == b.tobytes()
    # merged .hmg -> .csv -> .hmg (trans modes 5 and 4)
    for mod, tag in ((th, "t"), (jh, "j")):
        mod.save_dists(tmp_path / f"{tag}.csv", nt, dt)
        mod.save_dists(tmp_path / f"{tag}.hmg",
                       *mod.load_dists(tmp_path / f"{tag}.csv"))
    for ext in ("csv", "hmg"):
        assert (tmp_path / f"t.{ext}").read_bytes() \
            == (tmp_path / f"j.{ext}").read_bytes()


def test_merge_dists_rejects_what_the_original_rejects():
    a = (["cA"], [np.zeros(4, np.uint16)])
    for bad in [(["cB"], [np.zeros(4, np.uint16)]),
                (["cA"], [np.zeros(3, np.uint16)]),
                (None, [np.zeros(4, np.uint16)] * 2)]:
        with pytest.raises(ValueError) as et:
            th.merge_dists([a, bad])
        with pytest.raises(ValueError) as ej:
            jh.merge_dists([a, bad])
        assert str(et.value) == str(ej.value)


def test_read_hmg_rejects_other_files(tmp_path):
    p = tmp_path / "x.hmg"
    p.write_bytes(b"nope" + bytes(100))
    with pytest.raises(ValueError, match="not a .hmg"):
        th.read_hmg(p)
