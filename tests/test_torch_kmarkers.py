"""kmarkers, prekmarkers and pseudogenome of the port against the JAX
package on the CPU, with the same inputs and tolerance 0 (everything here
is integer): the pass codes of `kmarkers_pass` against
`_kmarkers_pass_factory()` batch by batch, the device arrays of
`_fast_device_arrays`, `find_cultivar_markers` at min_hamming 1-3 with and
without run extension, and the CLI's output bytes of `pseudogenome`,
`kmarkers` and `prekmarkers`. The committed golden is held in
tests/test_torch_kmarkers_golden.py, the copied host functions in
tests/test_torch_rehomed.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.index.sfx_index import SfxIndex as JIndex
from kit4b_tpu.kmer import kmarkers as jk
from kit4b_tpu_torch import native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.index.sfx_index import SfxIndex as PIndex
from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
from kit4b_tpu_torch.kmer import kmarkers as pk
from test_torch_kmarkers_card import few_threads  # noqa: F401

K = 50


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def cultivars(tmp_path_factory, lib):
    """tests/test_kmarkers.py's two cultivars (B = A's backbone with 0.5 %
    SNPs, A with a private 600 bp insert), plus a cultivar C of two
    chromosomes holding reverse-complemented Hamming-1 and Hamming-2
    neighbours of two windows of A's insert and an exact copy of a third.
    Returns (FASTA specs, JAX pieces, port pieces), each (genome, index,
    chrom_cult, names)."""
    d = tmp_path_factory.mktemp("cult")
    rng = np.random.default_rng(55)
    shared = rng.integers(0, 4, 40_000).astype(np.uint8)
    unique = rng.integers(0, 4, 600).astype(np.uint8)
    seq_a = np.concatenate([shared[:20_000], unique, shared[20_000:]])
    seq_b = shared.copy()
    snp_idx = rng.choice(len(seq_b), 200, replace=False)
    seq_b[snp_idx] = (seq_b[snp_idx] + 1 + rng.integers(0, 3, 200)) % 4
    c1 = rng.integers(0, 4, 3000).astype(np.uint8)
    c2 = rng.integers(0, 4, 2000).astype(np.uint8)
    for i, (src, offs) in enumerate(((20_100, [7]), (20_300, [10, 44]))):
        w = seq_a[src:src + K].copy()
        w[offs] = (w[offs] + 1) % 4
        c1[500 + 800 * i:500 + 800 * i + K] = np.where(
            w[::-1] < 4, 3 - w[::-1], w[::-1])
    c2[100:150] = seq_a[20_400:20_450]          # an exact copy: rejected
    write_fasta(d / "a.fa", [SeqRecord("chrA", "", seq_a)])
    write_fasta(d / "b.fa", [SeqRecord("chrB", "", seq_b)])
    write_fasta(d / "c1.fa", [SeqRecord("chrC1", "", c1)])
    write_fasta(d / "c2.fa", [SeqRecord("chrC2", "", c2)])
    specs = {"A": [d / "a.fa"], "B": [d / "b.fa"],
             "C": [d / "c1.fa", d / "c2.fa"]}
    jg, jcc, jnames = jk.build_pseudogenome(specs)
    pg, pcc, pnames = pk.build_pseudogenome(specs)
    return (specs, (jg, JIndex.build(jg), jcc, jnames),
            (pg, PIndex.build(pg), pcc, pnames))


@pytest.mark.parametrize("read_len", [25, 50, 100])
def test_fast_device_arrays_match_jax(cultivars, read_len):
    _, (_, jidx, _, _), (_, pidx, _, _) = cultivars
    jv, js, jl = jk._fast_device_arrays(jidx, read_len)
    pv, ps, pl = pk._fast_device_arrays(pidx, read_len, torch.device("cpu"))
    assert (ps.dtype, pl.dtype) == (torch.int32, torch.int32)
    assert (js.dtype, jl.dtype) == (jnp.int32, jnp.int32)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    # gview: the same rows, 32-bit words in the port's int64 carrier
    assert pv.dtype == torch.int64 and tuple(pv.shape) == jv.shape
    np.testing.assert_array_equal(pv.numpy(),
                                  np.asarray(jv).astype(np.int64))


@pytest.mark.parametrize("min_hamming", [1, 2, 3])
@pytest.mark.parametrize("n_compact,max_ml,batch", [(24, 48, 4096),
                                                    (256, 128, 512)])
def test_pass_codes_match_jax_batch_by_batch(cultivars, min_hamming,
                                             n_compact, max_ml, batch):
    """Batches over the private insert, A's SNP-shared backbone and the
    chromosome ends, the last padded; both tiers' capacities."""
    _, (jg, jidx, jcc, _), (pg, pidx, pcc, _) = cultivars
    kw = dict(K=K, genome_len=len(pg.seq),
              offsets=pk.core_offsets(K, min_hamming, pidx.lut_k),
              lut_k=pidx.lut_k, n_compact=n_compact, max_ml=max_ml,
              min_hamming=min_hamming, target=0)
    cpu = torch.device("cpu")
    pdev = (*pk._fast_device_arrays(pidx, K, cpu), torch.from_numpy(pg.seq),
            torch.from_numpy(pg.starts.astype(np.int32)),
            torch.from_numpy(pcc))
    jdev = (*jk._fast_device_arrays(jidx, K), jnp.asarray(jg.seq),
            jnp.asarray(jg.starts.astype(np.int32)), jnp.asarray(jcc))
    kpass = jk._kmarkers_pass_factory()
    rng = np.random.default_rng(min_hamming)
    n_pos = int(pg.lengths[0]) - K + 1
    firsts = [19_800, 0, n_pos - batch // 2, int(rng.integers(0, n_pos))]
    seen = set()
    for first in firsts:
        qp = np.arange(first, min(first + batch, n_pos), dtype=np.int32)
        qp = np.concatenate([qp, np.zeros(batch - len(qp), np.int32)])
        got = pk.kmarkers_pass(*pdev, torch.from_numpy(qp), **kw).numpy()
        want = np.asarray(kpass(*jdev, jnp.asarray(qp), **kw))
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
        seen |= set(np.unique(got).tolist())
    assert {0, 1} <= seen


@pytest.mark.parametrize("min_hamming", [1, 2, 3])
@pytest.mark.parametrize("extend", [False, True])
def test_find_cultivar_markers_match_jax(cultivars, min_hamming, extend):
    _, (_, jidx, jcc, _), (_, pidx, pcc, _) = cultivars
    kw = dict(kmer_len=K, min_hamming=min_hamming, extend=extend,
              batch=16384)
    want = jk.find_cultivar_markers(jidx, jcc, 0, **kw)
    stats = {}
    got = pk.find_cultivar_markers(pidx, pcc, 0, device="cpu", stats=stats,
                                   **kw)
    assert [(m.chrom, m.start, m.length) for m in got] == \
        [(m.chrom, m.start, m.length) for m in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.seq, b.seq)
    assert len(got) > 0 and stats["tier1"] == 40_600 - K + 1
    # the private insert is marked; its neighbours in C reject windows
    acc = {p for m in got for p in range(m.start, m.start + m.length - K + 1)}
    assert 20_050 in acc and 20_400 not in acc
    assert (20_100 in acc) == (min_hamming <= 1)
    assert (20_300 in acc) == (min_hamming <= 2)


def test_marker_guard_refuses_genomes_past_2_30(cultivars):
    """2*G+1 must fit int32, as the hit ids are int32 (item 18)."""
    _, _, (pg, pidx, pcc, _) = cultivars
    big = np.broadcast_to(np.uint8(0), (2 ** 30,))
    huge = PIndex(type(pg)(pg.names, pg.starts, pg.lengths, big),
                  pidx.lut_k, pidx.sa_clean, pidx.lut)
    with pytest.raises(ValueError, match="item 18"):
        pk.find_cultivar_markers(huge, pcc, 0, device="cpu")


def _cli_both(tmp_path, cmd, name, *args, device=True):
    """Runs one command through both CLIs; returns the two output paths
    (`{tag}` in an argument names each side's own file)."""
    outs = []
    for tag, main in (("port", port_main), ("jax", jax_main)):
        out = tmp_path / f"{tag}_{name}"
        argv = [cmd, *[str(a).replace("{tag}", tag) for a in args],
                "-o", str(out)]
        if tag == "port" and device:
            argv += ["--device", "cpu"]
        assert main(argv) == 0, (tag, argv)
        outs.append(out)
    return outs


def _specs(specs):
    return [f"{n}=" + ",".join(map(str, paths)) for n, paths in specs.items()]


def test_cli_pseudogenome_bytes_match_jax(tmp_path, cultivars):
    specs = _specs(cultivars[0])
    port, jax = _cli_both(tmp_path, "pseudogenome", "pg.fa", "-c", *specs,
                          "-B", tmp_path / "{tag}_pg.bed", device=False)
    assert port.read_bytes() == jax.read_bytes()
    assert (tmp_path / "port_pg.bed").read_bytes() == \
        (tmp_path / "jax_pg.bed").read_bytes()
    assert port.read_text().count(">") == 4


@pytest.mark.parametrize("flags", [["-m", "1"], ["-m", "0", "-e", "1"],
                                   ["-m", "1", "-x", "-e", "3"],
                                   ["-t", "C", "-K", "40"]])
def test_cli_kmarkers_bytes_match_jax(tmp_path, cultivars, flags):
    specs = _specs(cultivars[0])
    target = [] if "-t" in flags else ["-t", "A"]
    port, jax = _cli_both(tmp_path, "kmarkers", "m.fa", "-c", *specs,
                          *target, *flags)
    assert port.read_bytes() == jax.read_bytes()
    assert port.read_text().count(">") > 0


@pytest.mark.parametrize("flags", [[], ["-K", "12", "-M", "1"],
                                   ["-m", "3", "-K", "20"],
                                   ["-K", "14", "-s", "4", "-S", "1"],
                                   ["-K", "10", "-s", "3", "-S", "2",
                                    "-m", "2"]])
def test_cli_prekmarkers_bytes_match_jax(tmp_path, cultivars, flags):
    specs = _specs(cultivars[0])
    port, jax = _cli_both(tmp_path, "prekmarkers", "p.csv", "-c", *specs,
                          *flags, device=False)
    assert port.read_bytes() == jax.read_bytes()
    assert port.read_text().startswith('"KMer","A","B","C"\n')


def test_cli_kmarkers_unknown_target_fails(tmp_path, cultivars, capsys):
    rc = port_main(["kmarkers", "-c", *_specs(cultivars[0]), "-t", "Z",
                    "-o", str(tmp_path / "m.fa"), "--device", "cpu"])
    assert rc == 1 and "target cultivar 'Z'" in capsys.readouterr().err


def test_cli_kmarkers_without_cuda_fails(tmp_path, cultivars, capsys,
                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = port_main(["kmarkers", "-c", *_specs(cultivars[0]), "-t", "A",
                    "-o", str(tmp_path / "m.fa")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err
    assert not (tmp_path / "m.fa").exists()
