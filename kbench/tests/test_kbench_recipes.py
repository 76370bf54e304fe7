"""The frozen input recipes repeat for a seed and keep their model, and
the minmm bound counts chip_smoke.py's operations at the 2:4-sparse rate."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

from kbench import recipes, roofline
from conftest import tiny

R64 = [230_218, 813_184, 316_620, 1_531_933, 576_874, 270_161, 1_090_940,
       562_643, 439_888, 745_751, 666_816, 1_078_177, 924_431, 784_333,
       1_091_291, 948_066]


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", ["hammings.yeast_r64.k25_node1of4",
                                  "kalign_se.ecoli_k12.illumina100_30x"])
def test_genome_repeats_for_a_seed(name):
    _, _, config, _ = tiny(name)
    a = recipes.genome(2**31 + 7, config["genome"])
    b = recipes.genome(2**31 + 7, config["genome"])
    c = recipes.genome(2**31 + 8, config["genome"])
    assert _digest(*a[1]) == _digest(*b[1]) != _digest(*c[1])
    assert a[2] == b[2]


def test_r64_genome_plants_copies_and_n_runs():
    _, _, config, _ = tiny("hammings.yeast_r64.k25_node1of4")
    g = config["genome"]
    names, chroms, planted = recipes.r64_genome(5, g)
    assert [len(c) for c in chroms] == g["lengths"] and names == g["names"]
    assert len(planted) == g["copies"]
    assert sum(int((c == recipes.BASE_N).sum()) for c in chroms) >= 50
    for i, (c, d, L) in enumerate(planted):
        assert 0 < c < len(chroms) - 1 and L == g["copy_len"]


def test_reads_repeat_and_keep_the_illumina_model():
    codes = recipes.random_genome(3, {"name": "g", "length": 50_000})[1][0]
    spec = {"n_reads": 20_000, "read_len": 100, "subs_rate": 0.02}
    n1, r1, t1 = recipes.illumina_se_reads(2**33 + 1, "g", codes, spec)
    n2, r2, t2 = recipes.illumina_se_reads(2**33 + 1, "g", codes, spec)
    assert _digest(n1, r1) == _digest(n2, r2)
    win = np.lib.stride_tricks.sliding_window_view(codes, 100)[t1["start"]]
    fwd = r1.copy()
    rev = t1["strand"] == 1
    fwd[rev] = recipes.revcomp(fwd[rev])
    assert np.array_equal((fwd != win).sum(1), t1["subs"])
    share = np.bincount(t1["subs"], minlength=9) / len(t1["subs"])
    want = recipes.subs_count_probs(0.02, 100)
    assert np.abs(share - want).max() < 0.01
    assert abs(want[0] - 0.98 ** 100) < 1e-12
    # 3'-skewed: the last fifth of the read takes more substitutions
    hit = fwd != win
    hit[rev] = hit[rev][:, ::-1]
    assert hit[:, 80:].sum() > 2 * hit[:, :20].sum()
    name = n1[0].tobytes().decode().split("|")
    assert name[0] == "lcl" and int(name[3]) == t1["start"][0]
    assert name[6] == "+-"[t1["strand"][0]]


def test_reads_fasta_is_one_line_a_read(tmp_path):
    codes = recipes.random_genome(3, {"name": "g", "length": 5_000})[1][0]
    names, reads, _ = recipes.illumina_se_reads(
        1, "g", codes, {"n_reads": 10, "read_len": 100, "subs_rate": 0.02})
    path = tmp_path / "r.fa"
    recipes.write_reads_fasta(path, names, reads)
    lines = path.read_bytes().split(b"\n")
    assert len(lines) == 21 and lines[0] == b">" + names[0].tobytes()
    assert lines[1] == recipes.ACGTN[reads[0]].tobytes()


def test_minmm_bound_counts_chip_smokes_operations():
    ops = roofline.minmm_ops(2 ** 21, 3_017_728,
                             roofline.sparse_channels(25))
    assert f"{ops:.3e}" == "1.620e+15"
    t = roofline.minmm_bound_s(2 ** 21, 3_017_728, 25,
                               "NVIDIA H100 80GB HBM3")
    assert abs(t - ops / 3958e12) < 1e-12          # bound by operations
    assert round(t * 1e3, 2) == 409.33
    G = sum(R64) + len(R64)          # the codes and a separator each
    shape = roofline.hammings_node_shape(G, 25, 0, 4, True)
    assert shape == {"rows": 12_072_960, "cols": 3_017_728, "K": 25,
                     "strands": 2}
