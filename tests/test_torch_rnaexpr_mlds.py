"""The port's two float device uses against the JAX package: `rnaexpr`'s
Pearson matrix and replicate report (kit4b_tpu_torch/align/rnaexpr.py) and
`sarscov2ml`'s feature linkages (kit4b_tpu_torch/tools/mlds.py), through
the functions and the CLI on the same seeded inputs.

Tolerances, and why:
- The Pearson matrix is float32 throughout in both packages (center, norm,
  one [S, F] @ [F, S] product); the two differ only in float32 rounding
  over F products, so r is held within R_TOL = 1e-5 absolute (an F = 2,000
  dot product rounds at about 1e-7 relative; the rest is headroom).
- The replicate report: names and the Consistent column exactly (the
  inputs are built so that every sample's best and second-best r differ
  by more than R_TOL, so the argmax cannot flip); partner_r and best_r
  within R_TOL (plus their 6-decimal rounding); z and the p-value within
  the bound r's tolerance gives through the derivative of Fisher's z,
  sqrt(n - 3) / (1 - r^2), which grows without limit near |r| = 1, so no
  fixed tolerance is used (`make_assembly_golden.rnaexpr_close`).
- The co-support counts of sarscov2ml are float32 sums of 0/1 values,
  exact while the rows are fewer than 2^24: the linkages CSV is held byte
  for byte.
And nothing in the port lowers float32 matmul precision (TF32).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from kit4b_tpu.align import rnaexpr as jrna
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.tools import mlds as jmlds
from kit4b_tpu_torch.align import rnaexpr as prna
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.tools import make_assembly_golden as mg
from kit4b_tpu_torch.tools import mlds as pmlds

R_TOL = 1e-5        # see the module docstring
assert R_TOL == mg.R_TOL
PORT = Path(__file__).resolve().parent.parent / "kit4b_tpu_torch"


def _counts(seed, F, S, swaps=()):
    """A [F, S] count matrix of adjacent replicate pairs with distinct
    noise levels, as float64 with one decimal, and sample names with the
    given pairs of columns relabelled."""
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 40.0, size=(F, S // 2))
    cols = []
    for j in range(S // 2):
        for _ in range(2):
            cols.append(base[:, j] * np.exp(rng.normal(0, 0.05 + 0.03 * j,
                                                       F)))
    counts = np.round(np.stack(cols, 1), 1)
    names = [f"s{i:02d}" for i in range(S)]
    for a, b in swaps:
        names[a], names[b] = names[b], names[a]
    return names, counts


def _no_near_ties(r):
    r = r.copy()
    np.fill_diagonal(r, -2.0)
    top2 = np.sort(r, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 10 * R_TOL).all()


@pytest.mark.parametrize("F,S", [(400, 12), (2_000, 24), (37, 6)])
def test_pearson_matrix_within_tolerance(F, S):
    _, counts = _counts(F + S, F, S)
    want = jrna.pearson_matrix(counts)
    got = prna.pearson_matrix(counts, "cpu")
    assert got.dtype == want.dtype == np.float32 and got.shape == (S, S)
    assert np.abs(got - want).max() <= R_TOL
    ref = np.corrcoef(counts.T)           # float64, an independent check
    assert np.abs(got - ref).max() <= 1e-4


def test_fisher_z_and_csv_writer_match(tmp_path):
    for r in (-1.0, -0.3, 0.0, 0.5, 0.999, 1.0):
        for n in (2, 5, 400):
            assert prna._fisher_z(r, n) == jrna._fisher_z(r, n)
    rows = [{"sample": "a", "partner": "b", "partner_r": 0.5, "best": "c",
             "best_r": 0.9, "z": 1.25, "pvalue": 0.2, "consistent": False}]
    jrna.write_consistency_csv(tmp_path / "j.csv", rows)
    prna.write_consistency_csv(tmp_path / "p.csv", rows)
    assert (tmp_path / "p.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("partners", [False, True])
def test_replicate_consistency_within_tolerance(tmp_path, partners):
    names, counts = _counts(5, 600, 16, swaps=((2, 5), (9, 12)))
    _no_near_ties(jrna.pearson_matrix(counts))
    part = {f"s{i:02d}": f"s{i ^ 1:02d}" for i in range(16)} \
        if partners else None
    want = jrna.replicate_consistency(names, counts, part)
    got = prna.replicate_consistency(names, counts, part, device="cpu")
    # each swap of two labels across pairs leaves four samples with a
    # labeled partner that is not their replicate
    assert sum(not w["consistent"] for w in want) == (8 if partners else 0)
    jrna.write_consistency_csv(tmp_path / "j.csv", want)
    prna.write_consistency_csv(tmp_path / "p.csv", got)
    assert mg.rnaexpr_close((tmp_path / "p.csv").read_text(),
                            (tmp_path / "j.csv").read_text(), 600)


def test_cli_rnaexpr_within_tolerance(tmp_path):
    names, counts = _counts(6, 500, 10, swaps=((1, 6),))
    with open(tmp_path / "c.csv", "w") as f:
        f.write("Feature," + ",".join(f'"{n}"' for n in names) + "\n")
        for i, row in enumerate(counts):
            f.write(f'"g{i}",' + ",".join(f"{v:g}" for v in row) + "\n")
    (tmp_path / "p.csv").write_text("".join(
        f"s{i:02d},s{i ^ 1:02d}\n" for i in range(10)))
    for extra in ([], ["-c", str(tmp_path / "p.csv")]):
        argv = ["rnaexpr", "-i", str(tmp_path / "c.csv"), *extra]
        assert jax_main(argv + ["-o", str(tmp_path / "j.out")]) == 0
        assert port_main(argv + ["-o", str(tmp_path / "p.out"), "--device",
                                 "cpu"]) == 0
        assert mg.rnaexpr_close((tmp_path / "p.out").read_text(),
                                (tmp_path / "j.out").read_text(), 500)
    assert ",0\n" in (tmp_path / "p.out").read_text()


def _class_matrix(seed, R, F, groups):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 3, size=(R, F))
    for cols, n in groups:
        rows = rng.choice(R, n, replace=False)
        m[np.ix_(rows, cols)] = rng.integers(3, 6, size=(n, len(cols)))
    m[rng.random((R, F)) < 0.05] = 3
    return m.astype(float)


@pytest.mark.parametrize("num_linked,min_rows,min_class", [
    (3, 30, 3), (4, 20, 3), (2, 40, 4), (5, 10, 3)])
def test_find_feature_linkages_exact(num_linked, min_rows, min_class):
    m = _class_matrix(num_linked, 800, 40, [((1, 5, 9, 30), 90),
                                           ((3, 17, 22, 25, 33), 70),
                                           ((8, 12), 120)])
    names = [f"f{i}" for i in range(40)]
    kw = dict(num_linked=num_linked, min_rows=min_rows, min_class=min_class)
    want = jmlds.find_feature_linkages(m, names, **kw)
    got = pmlds.find_feature_linkages(m, names, device="cpu", **kw)
    assert got == want and want


def test_cli_genmlds_and_sarscov2ml_bytes(tmp_path):
    m = _class_matrix(7, 500, 24, [((2, 4, 6), 80), ((10, 11, 20), 60)])
    with open(tmp_path / "m.csv", "w") as f:
        f.write("Isolate," + ",".join(f"F{i}" for i in range(24)) + "\n")
        for r, row in enumerate(m):
            f.write(f"iso{r}," + ",".join(str(int(v)) if v else ""
                                          for v in row) + "\n")
    (tmp_path / "l.csv").write_text("".join(f'"iso{r}",{"XY"[r % 2]}\n'
                                            for r in range(0, 500, 3)))
    runs = [["sarscov2ml", "-i", str(tmp_path / "m.csv"), "-l", "3", "-r",
             "40"],
            ["genmlds", "-i", str(tmp_path / "m.csv")],
            ["genmlds", "-i", str(tmp_path / "m.csv"), "-l",
             str(tmp_path / "l.csv")]]
    for argv in runs:
        dev = ["--device", "cpu"] if argv[0] == "sarscov2ml" else []
        assert jax_main(argv + ["-o", str(tmp_path / "j.out")]) == 0
        assert port_main(argv + ["-o", str(tmp_path / "p.out")] + dev) == 0
        assert (tmp_path / "p.out").read_bytes() == \
            (tmp_path / "j.out").read_bytes()
        assert (tmp_path / "p.out").read_text().count("\n") > 1


def test_nothing_in_the_port_enables_tf32():
    """No file of the port sets TF32 or a float32 matmul precision below
    "highest", and after a Pearson matrix the process still has neither."""
    bad = []
    for path in sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = node.attr if isinstance(node, ast.Attribute) else \
                node.id if isinstance(node, ast.Name) else ""
            if name in ("allow_tf32", "set_float32_matmul_precision",
                        "allow_bf16_reduced_precision_reduction",
                        "allow_fp16_reduced_precision_reduction"):
                bad.append(f"{path.name}:{node.lineno}")
    assert bad == []
    _, counts = _counts(1, 50, 6)
    prna.pearson_matrix(counts, "cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
