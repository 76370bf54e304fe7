"""Restricted-mode hammings (`hammings -r`) of the port against the JAX
package on the CPU, tolerance 0: `hammings_restricted` on the three genomes
of tests/test_hammings.py and on genomes with repeats, N runs and planted
near-copies, and the CLI's output bytes. Also the rule chip_smoke.py's
phase 10 holds the card to, checked here against the exhaustive minimum:
restricted mode reports only real hits, so it never reads below the true
minimum, and it finds every hit of at most W - 1 mismatches."""
import numpy as np
import pytest
import torch

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.index.sfx_index import SfxIndex as JIndex
from kit4b_tpu.io.fasta import Genome as JGenome
from kit4b_tpu.kmer import hammings as jh
from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.index.sfx_index import SfxIndex as PIndex
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord, write_fasta
from kit4b_tpu_torch.kmer import hammings as ph
from kit4b_tpu_torch.tools.make_kmarkers_golden import restricted_cases
from test_torch_kmarkers_card import few_threads  # noqa: F401



@pytest.fixture(scope="module", autouse=True)
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def _both(g: Genome, lut_k, K, **kw):
    """(port, JAX) restricted outputs on the same genome, each on its own
    package's SA-IS index."""
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    got = ph.hammings_restricted(PIndex.build(g, lut_k), K, device="cpu",
                                 **kw)
    want = jh.hammings_restricted(JIndex.build(jg, lut_k), K, **kw)
    return got, want


def planted(seed, n=3000, n_runs=(1, 3, 6)):
    """A seeded genome of two chromosomes with forward and
    reverse-complement near-copies (0-3 substitutions), a poly-T run
    longer than a cut bucket (the lexicographic order of its suffixes runs
    backwards along it), and N runs of the given lengths."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = rng.integers(0, 4, n // 2).astype(np.uint8)
    for i in range(8):
        src = int(rng.integers(0, n - 60))
        seg = a[src:src + 60].copy()
        subs = rng.choice(60, i % 4, replace=False)
        seg[subs] = (seg[subs] + 1) % 4
        if i % 2:
            seg = dna.revcomp(seg)
        dst = int(rng.integers(0, len(b) - 60))
        b[dst:dst + 60] = seg
    a[n // 2:n // 2 + 120] = 3
    for r in n_runs:
        p = int(rng.integers(0, n - r))
        a[p:p + r] = dna.BASE_N
    return Genome.from_records([SeqRecord("a", "", a), SeqRecord("b", "", b)])


@pytest.mark.parametrize("case", [c[0] for c in restricted_cases()])
def test_matches_jax_on_the_golden_genomes(case):
    """The three genomes of tests/test_hammings.py (their seeds) and the
    golden's part of the kmarkers workload."""
    _, g, lut_k, K, mh, batch = next(c for c in restricted_cases()
                                     if c[0] == case)
    got, want = _both(g, lut_k, K, max_hamming=mh, batch=batch)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K,lut_k,mh,kw", [
    (25, 11, 1, {}), (25, 11, 3, {}), (25, None, 3, {"antisense": False}),
    (20, 8, 2, {"batch": 700}), (32, 8, 4, {"n_compact": 32}),
    (12, 8, 3, {})])
def test_matches_jax_on_planted_genomes(K, lut_k, mh, kw):
    got, want = _both(planted(K + mh), lut_k, K, max_hamming=mh, **kw)
    np.testing.assert_array_equal(got, want)
    assert int(got.min()) == 0


@pytest.mark.parametrize("mh", [1, 3])
def test_rule_against_the_oracle(mh):
    """At every window of A/C/G/T only, with W = min(mh + 1, K // lut_k)
    seed windows: equal to the true minimum where it is at most W - 1,
    else in [min(true, mh + 1), mh + 1]. Here K 25, lut_k 11, W 2, as on
    the chrIV-length genome of chip_smoke.py phase 10."""
    K, lut_k = 25, 11
    g = planted(5, n=1800, n_runs=(2, 30))
    got = ph.hammings_restricted(PIndex.build(g, lut_k), K, max_hamming=mh,
                                 device="cpu").astype(int)
    # the max-match engine's plain version, which
    # tests/test_torch_hammings_mxu.py holds to hammings_oracle
    want = ph.hammings_exhaustive(g.seq, K, device="cpu").astype(int)
    W = min(mh + 1, K // lut_k)
    nk = len(g.seq) - K + 1
    clean = ~(np.lib.stride_tricks.sliding_window_view(g.seq, K) >= 4) \
        .any(1)
    got, want = got[:nk][clean], want[:nk][clean]
    low = want <= W - 1
    np.testing.assert_array_equal(got[low], want[low])
    assert (got[~low] >= np.minimum(want[~low], mh + 1)).all()
    assert (got[~low] <= mh + 1).all()
    if mh == 1:                     # W - 1 = mh: exact up to the cap
        np.testing.assert_array_equal(got, np.minimum(want, 2))
    assert low.sum() > 100 and (~low).sum() > 100


def test_depends_on_bucket_order():
    """Cut buckets make the answer depend on the order within a bucket:
    the lexicographic index (what the CLI builds) and the position-ordered
    bucket index disagree on a genome with a long poly-T run."""
    g = planted(9)
    K, mh = 20, 3
    sa_is = ph.hammings_restricted(PIndex.build(g, 8), K, max_hamming=mh,
                                   device="cpu")
    by_pos = ph.hammings_restricted(PIndex.build_buckets(g, 8), K,
                                    max_hamming=mh, device="cpu")
    assert (sa_is != by_pos).any()


@pytest.fixture
def fasta(tmp_path):
    g = planted(3)
    path = tmp_path / "g.fa"
    write_fasta(path, [SeqRecord(n, "", g.chrom_codes(i))
                       for i, n in enumerate(g.names)])
    return path


@pytest.mark.parametrize("out,flags", [
    ("r3.hmg", ["-r", "3", "-K", "25"]), ("r1.csv", ["-r", "1", "-K", "20"]),
    ("r2.npy", ["-r", "2", "-K", "16", "-y"]),
    ("mesh.hmg", ["-r", "3", "-K", "25", "-M"])])
def test_cli_bytes_match_jax(tmp_path, fasta, out, flags):
    """`-M` with `-r` takes the restricted path, as in the JAX package."""
    outs = []
    for tag, main, extra in (("port", port_main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
        path = tmp_path / f"{tag}_{out}"
        assert main(["hammings", "-i", str(fasta), "-o", str(path),
                     *flags, *extra]) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 1000


def test_cli_without_cuda_fails(tmp_path, fasta, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = port_main(["hammings", "-i", str(fasta), "-o",
                    str(tmp_path / "x.hmg"), "-r", "3"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "x.hmg").exists()
