"""The port stands alone: no module of kit4b_tpu_torch, and not
chip_smoke.py, imports the JAX package kit4b_tpu or jax. An `ast` scan of
every file proves it line by line; subprocesses with both names blocked in
`sys.modules` import every module of the port and run its CLI (`index`,
`simreads`, `hammings` exhaustive and `-r`, `kalign` single and paired
ends, `pseudogenome`, `kmarkers`, `prekmarkers`, with `--device cpu` where
a command takes one) on a small
seeded genome. The runs that build a suffix index need the port's host
library and skip without it. This file imports neither package either:

    python -m pytest --noconftest tests/test_torch_standalone.py
"""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kit4b_tpu_torch"
FILES = sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")) \
    + ["chip_smoke.py"]
BLOCKED = ("kit4b_tpu", "jax")

# blocks both packages, then runs the code that follows it
PRELUDE = ("import sys\n"
           "sys.modules['kit4b_tpu'] = None\n"
           "sys.modules['jax'] = None\n"
           f"sys.path.insert(0, {str(REPO)!r})\n")


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


def _run(code: str, cwd: Path, timeout=300):
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], cwd=cwd,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def genome_fa(tmp_path_factory):
    """A seeded 6 kbp genome in two chromosomes, with Ns, and chrA's bases
    1000-1099 copied into chrB."""
    import numpy as np
    rng = np.random.default_rng(2024)
    path = tmp_path_factory.mktemp("standalone") / "g.fa"
    a, b = (np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
            for n in (4000, 2000))
    a[rng.integers(1200, 4000, 10)] = b[rng.integers(0, 400, 5)] = ord("N")
    b[500:600] = a[1000:1100]
    with open(path, "w") as f:
        for name, s in (("chrA", a), ("chrB", b)):
            f.write(f">{name}\n{s.tobytes().decode()}\n")
    return path


@pytest.fixture(scope="module")
def host_library():
    """Skips unless the port's host library builds here (checked in a
    subprocess with both packages blocked)."""
    out = subprocess.run([sys.executable, "-c", PRELUDE + (
        "from kit4b_tpu_torch import native\n"
        "try:\n"
        "    native.load()\n"
        "except native.NativeUnavailable as e:\n"
        "    print('unavailable:', e)\n")], capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    if out.stdout.startswith("unavailable"):
        pytest.skip(f"native library {out.stdout.strip()}")


@pytest.mark.parametrize("path", FILES)
def test_no_import_of_the_jax_package_or_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [n for n in _imported(tree)
           if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_sees_every_form_of_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom kit4b_tpu import dna\n"
                     "from kit4b_tpu_torch import cli\nfrom . import native\n"
                     "importlib.import_module('kit4b_tpu.io')\n")
    assert _imported(tree) == ["jax.numpy", "kit4b_tpu", "kit4b_tpu_torch",
                               "kit4b_tpu.io"]


def test_every_module_imports_with_both_blocked():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="kit4b_tpu_torch.")
        if m.name != "kit4b_tpu_torch.__main__")    # runs the CLI
    assert "kit4b_tpu_torch.index.sfx_index" in mods and len(mods) > 30
    out = _run("import importlib\n"
               f"for m in {mods!r}:\n"
               "    importlib.import_module(m)\n"
               "assert sys.modules['jax'] is None\n"
               "assert not [m for m in sys.modules if m.startswith"
               "(('kit4b_tpu.', 'jax.'))]\n"
               "print(len(sys.modules))\n", REPO)
    assert int(out.stdout.split()[-1]) > len(mods)


def test_cli_hammings_with_both_blocked(genome_fa, tmp_path):
    out = tmp_path / "g.npy"
    _run("from kit4b_tpu_torch import cli\n"
         f"rc = cli.main(['hammings', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(out)!r}, '-K', '12', '--device', 'cpu'])\n"
         "assert rc == 0, rc\n"
         "import numpy as np\n"
         f"d = np.load({str(out)!r})\n"
         "assert d.shape == (6002,) and int(d[:3989].max()) <= 12\n"
         "assert (d[1000:1089] == 0).all() and (d[1100:3989] > 0).mean() "
         "> 0.99\n",
         tmp_path)


def test_cli_index_and_kalign_with_both_blocked(genome_fa, tmp_path,
                                                host_library):
    kix, reads, sam = tmp_path / "g.kix", tmp_path / "r.fa", tmp_path / "o.sam"
    _run("from kit4b_tpu_torch import cli\n"
         "from kit4b_tpu_torch.io.fasta import Genome\n"
         "from kit4b_tpu_torch.sim import simreads\n"
         f"rc = cli.main(['index', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(kix)!r}])\n"
         "assert rc == 0, rc\n"
         f"g = Genome.load({str(genome_fa)!r})\n"
         "recs = simreads.sim_reads(g, simreads.SimParams(n_reads=200, "
         "read_len=60, seed=3, error_mode='uniform', subs_rate=0.01))\n"
         f"simreads.write_reads({str(reads)!r}, recs)\n"
         f"rc = cli.main(['kalign', '-i', {str(reads)!r}, '-I', "
         f"{str(kix)!r}, '-o', {str(sam)!r}, '-b', '256', '--device', "
         "'cpu'])\n"
         "assert rc == 0, rc\n", tmp_path)
    body = [ln.split("\t") for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) > 180
    assert all(int(c[1]) & 4 == 0 for c in body)
    truth = sum(c[0].split("|")[2] == c[2] and
                int(c[0].split("|")[3]) == int(c[3]) - 1 for c in body)
    assert truth == len(body)


def test_cli_hammings_restricted_with_both_blocked(genome_fa, tmp_path,
                                                  host_library):
    out = tmp_path / "r.npy"
    _run("from kit4b_tpu_torch import cli\n"
         f"rc = cli.main(['hammings', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(out)!r}, '-K', '24', '-r', '2', '--device', 'cpu'])\n"
         "assert rc == 0, rc\n"
         "import numpy as np\n"
         f"d = np.load({str(out)!r})\n"
         "assert d.shape == (6002,) and int(d[:3977].max()) <= 3\n"
         "assert (d[1000:1077] == 0).all() and (d[1100:3977] == 3).mean() "
         "> 0.9\n", tmp_path)


def test_cli_kmarkers_commands_with_both_blocked(genome_fa, tmp_path,
                                                 host_library):
    """chrA and chrB as two cultivars: pseudogenome, kmarkers and
    prekmarkers; chrB's copy of chrA's bases 1000-1099 is no marker."""
    a, b, pg, bed = (tmp_path / n for n in ("a.fa", "b.fa", "pg.fa",
                                            "pg.bed"))
    markers, pre = tmp_path / "m.fa", tmp_path / "p.csv"
    _run("from kit4b_tpu_torch import cli\n"
         "from kit4b_tpu_torch.io.fasta import read_seqs, write_fasta\n"
         f"ra, rb = read_seqs({str(genome_fa)!r})\n"
         f"write_fasta({str(a)!r}, [ra])\n"
         f"write_fasta({str(b)!r}, [rb])\n"
         f"c = ['A={a}', 'B={b}']\n"
         f"assert cli.main(['pseudogenome', '-c', *c, '-o', {str(pg)!r}, "
         f"'-B', {str(bed)!r}]) == 0\n"
         f"assert cli.main(['kmarkers', '-c', *c, '-t', 'A', '-o', "
         f"{str(markers)!r}, '-K', '30', '-m', '1', '--device', 'cpu']) == 0\n"
         f"assert cli.main(['prekmarkers', '-c', *c, '-o', {str(pre)!r}, "
         "'-K', '20']) == 0\n", tmp_path)
    assert pg.read_text().split("\n")[0] == ">A.chrA"
    assert bed.read_text().splitlines() == ["A.chrA\t0\t4000\tA\t0\t+",
                                            "B.chrB\t0\t2000\tB\t0\t+"]
    heads = [ln.split()[1].split("|") for ln in markers.read_text()
             .splitlines() if ln.startswith(">")]
    spans = [(int(s), int(s) + int(n)) for _, s, n in heads]
    assert spans and all(c == "A.chrA" for c, _, _ in heads)
    assert not any(s <= 1010 and 1090 <= e for s, e in spans)
    rows = pre.read_text().splitlines()
    assert rows[0] == '"KMer","A","B"' and len(rows) > 70


def test_cli_simreads_and_pe_kalign_with_both_blocked(genome_fa, tmp_path,
                                                      host_library):
    """simreads -p with SNPs planted, then kalign -u -U 1 with a VCF: most
    pairs proper, at their truth loci."""
    kix, sam, vcf = tmp_path / "g.kix", tmp_path / "o.sam", tmp_path / "o.vcf"
    r1, r2 = tmp_path / "r1.fa", tmp_path / "r2.fa"
    _run("from kit4b_tpu_torch import cli\n"
         f"assert cli.main(['index', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(kix)!r}]) == 0\n"
         f"assert cli.main(['simreads', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(r1)!r}, '-O', {str(r2)!r}, '-p', '-n', '150', '-l', '80', "
         "'-j', '200', '-J', '400', '-e', 'illumina', '-z', '0.01', '-N', "
         "'2000', '-S', '4']) == 0\n"
         f"assert cli.main(['kalign', '-i', {str(r1)!r}, '-I', {str(kix)!r},"
         f" '-o', {str(sam)!r}, '-u', {str(r2)!r}, '-U', '1', '-d', '150', "
         f"'-D', '450', '-S', {str(vcf)!r}, '-p', '2', '-b', '256', "
         "'-M', '1', '--device', 'cpu']) == 0\n", tmp_path)
    body = [ln.split("\t") for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    proper = [c for c in body if int(c[1]) & 2]
    assert len(body) == 300 and len(proper) > 250
    truth = sum(c[0].split("|")[2] == c[2] and
                int(c[0].split("|")[3]) == int(c[3]) - 1 for c in proper)
    assert truth > 0.95 * len(proper)
    assert vcf.read_text().startswith("##fileformat=VCF")
