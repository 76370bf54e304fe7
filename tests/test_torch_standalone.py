"""The port stands alone: no module of kit4b_tpu_torch, and not
chip_smoke.py, imports the JAX package kit4b_tpu or jax. An `ast` scan of
every file proves it line by line; subprocesses with both names blocked in
`sys.modules` import every module of the port and run its CLI (`index`,
`simreads`, `hammings` exhaustive and `-r`, `kalign` single ends (also
with the -y and -C rescues, with the phases and filters into BAM with a
BAI, with the SNP side outputs) and paired ends (also of unequal mates),
`genpba`, `index -m 1` with `kalign --bisulfite`, `pseudogenome`,
`kmarkers`, `prekmarkers`, `filter`, `assemb`, `mergeoverlaps`,
`scaffold`, `pescaffold`, `rnaexpr`, `genmlds`, `sarscov2ml`, the
PacBio commands `pbfilter`, `ecreads`, `pbassemb` and `eccontigs`, and
`blitz`, `hrdx`, `kmerdist`, `benchmark`, `alignsbs`, `ngsqc`, `maploci`
and `rnade` on the long-tail golden's inputs, and the PBA and haplotype
family `callhaplotypes`, `pbautils`, `snpmarkers`, `snps2pgsnps`,
`lochap2bed`, `markerseqs`, `repassemb`, `pangenome`, `seghaplotypes`,
`gbsmapsnps` and `dgts` on the haplotypes golden's inputs (modules
kmer.pba, pbautils2, callhaplotypes, haplogroups, allelescores, dgtqtl,
snpmarkers, gbs, tools.snpsfmt, pangenes, seghaps), with `--device cpu`
where a command takes one) on a small seeded genome. The
runs that build a suffix index need the port's host library and skip
without it. This file imports neither package either:

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


def test_cli_kalign_rescues_and_unequal_mates_with_both_blocked(
        genome_fa, tmp_path, host_library):
    """kalign -y -C on InDel reads (the full-stats route, record by record),
    then kalign -u on pairs whose mate 2 was cut to 60 bp (the host
    pairing)."""
    kix, reads, sam = tmp_path / "g.kix", tmp_path / "r.fa", tmp_path / "o.sam"
    r1, r2, pe_sam = tmp_path / "r1.fa", tmp_path / "r2.fa", tmp_path / "p.sam"
    _run("from kit4b_tpu_torch import cli\n"
         "from kit4b_tpu_torch.io.fasta import read_seqs, write_fasta\n"
         f"assert cli.main(['index', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(kix)!r}]) == 0\n"
         f"assert cli.main(['simreads', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(reads)!r}, '-n', '200', '-l', '80', '-X', '0.5', '-x', "
         "'3', '-S', '5']) == 0\n"
         f"assert cli.main(['kalign', '-i', {str(reads)!r}, '-I', "
         f"{str(kix)!r}, '-o', {str(sam)!r}, '-y', '20', '-C', '50', '-b', "
         "'256', '-M', '1', '--device', 'cpu']) == 0\n"
         f"assert cli.main(['simreads', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(r1)!r}, '-O', {str(r2)!r}, '-p', '-n', '100', '-l', '80', "
         "'-j', '200', '-J', '400', '-S', '6']) == 0\n"
         f"recs = list(read_seqs({str(r2)!r}))\n"
         "for r in recs:\n"
         "    r.codes = r.codes[:60]\n"
         f"write_fasta({str(r2)!r}, recs)\n"
         f"assert cli.main(['kalign', '-i', {str(r1)!r}, '-I', {str(kix)!r},"
         f" '-o', {str(pe_sam)!r}, '-u', {str(r2)!r}, '-d', '150', '-D', "
         "'450', '-b', '256', '-M', '1', '--device', 'cpu']) == 0\n",
         tmp_path)
    body = [ln.split("\t") for ln in sam.read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) == 200 and sum(c[5] != "*" for c in body) > 100
    assert any(c[5] not in ("*", "80M") for c in body)   # a rescue's CIGAR
    body = [ln.split("\t") for ln in pe_sam.read_text().splitlines()
            if not ln.startswith("@")]
    proper = [c for c in body if int(c[1]) & 2]
    assert len(body) == 200 and len(proper) > 150
    assert {len(c[9]) for c in proper} == {60, 80}


def test_cli_kalign_options_genpba_and_bisulfite_with_both_blocked(
        genome_fa, tmp_path, host_library):
    """kalign with -x -6 --mlmode 3 -Z -5 into a BAM with a BAI and the
    SNP side outputs (-S -g -3 -X --markerfile --snpcentroidfile), genpba,
    then index -m 1 and kalign --bisulfite."""
    kix, kbx, reads = tmp_path / "g.kix", tmp_path / "g.kbx", \
        tmp_path / "r.fa"
    bam, sam, bsam = tmp_path / "o.bam", tmp_path / "g.sam", \
        tmp_path / "b.sam"
    side = {k: str(tmp_path / k) for k in (
        "s.csv", "c.wig", "o.pba.npz", "d", "m.fa", "cent.csv", "gp.pba.npz")}
    _run("from kit4b_tpu_torch import cli\n"
         f"assert cli.main(['index', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(kix)!r}]) == 0\n"
         f"assert cli.main(['index', '-m', '1', '-i', {str(genome_fa)!r}, "
         f"'-o', {str(kbx)!r}]) == 0\n"
         f"assert cli.main(['simreads', '-i', {str(genome_fa)!r}, '-o', "
         f"{str(reads)!r}, '-n', '300', '-l', '80', '-S', '5', '-N', "
         "'5000']) == 0\n"
         f"assert cli.main(['kalign', '-i', {str(reads)!r}, '-I', "
         f"{str(kix)!r}, '-o', {str(bam)!r}, '--baindex', '-x', '10', "
         "'-6', '2', '--mlmode', '3', '-Z', 'chr', '-5', '3', '-p', '2', "
         f"'-S', {side['s.csv']!r}, '-b', '256', '--device', 'cpu']) == 0\n"
         f"assert cli.main(['kalign', '-i', {str(reads)!r}, '-I', "
         f"{str(kix)!r}, '-o', {str(sam)!r}, '-p', '2', '-S', "
         f"{side['s.csv']!r}, '-g', {side['c.wig']!r}, '-3', "
         f"{side['o.pba.npz']!r}, '-X', {side['d']!r}, '--markerfile', "
         f"{side['m.fa']!r}, '--snpcentroidfile', {side['cent.csv']!r}, "
         "'-b', '256', '--device', 'cpu']) == 0\n"
         f"assert cli.main(['genpba', '-i', {str(reads)!r}, '-I', "
         f"{str(kix)!r}, '-o', {side['gp.pba.npz']!r}, '-b', '256', "
         "'--device', 'cpu']) == 0\n"
         f"assert cli.main(['kalign', '--bisulfite', '-i', {str(reads)!r},"
         f" '-I', {str(kbx)!r}, '-o', {str(bsam)!r}, '-b', '256', "
         "'--device', 'cpu']) == 0\n"
         "from kit4b_tpu_torch.io.bam import read_bam\n"
         f"recs = list(read_bam({str(bam)!r}))\n"
         "assert len(recs) > 150, len(recs)\n"
         "assert any('S' in r.cigar for r in recs)\n", tmp_path)
    assert (tmp_path / "o.bam.bai").stat().st_size > 0
    for k in ("c.wig", "o.pba.npz", "d.disnp.csv", "d.trisnp.csv",
              "cent.csv", "gp.pba.npz"):
        assert (tmp_path / k).stat().st_size > 0, k
    assert sum(1 for ln in bsam.read_text().splitlines()
               if not ln.startswith("@")) > 100


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


def test_cli_assembly_and_float_commands_with_both_blocked(
        genome_fa, tmp_path, host_library):
    """simreads -p, then filter (-a, -D on the CPU), assemb -u,
    mergeoverlaps, scaffold and index + kalign + pescaffold onto chrA cut
    in two, and rnaexpr, genmlds and sarscov2ml on the assembly golden's
    CSVs."""
    _run("from pathlib import Path\n"
         "from kit4b_tpu_torch import cli\n"
         "from kit4b_tpu_torch.io.fasta import SeqRecord, read_seqs, "
         "write_fasta\n"
         "from kit4b_tpu_torch.tools import make_assembly_golden as mg\n"
         "d = Path('.')\n"
         f"assert cli.main(['simreads', '-i', {str(genome_fa)!r}, '-o', "
         "'r1.fa', '-O', 'r2.fa', '-p', '-n', '400', '-l', '80', '-j', "
         "'120', '-J', '260', '-S', '8']) == 0\n"
         "for m in 'r1.fa', 'r2.fa':\n"
         "    write_fasta(m, [SeqRecord(f'p{i}', '', r.codes) for i, r in "
         "enumerate(read_seqs(m))])\n"
         "chra = next(iter(read_seqs("
         f"{str(genome_fa)!r})))\n"
         "write_fasta('ctg.fa', [SeqRecord('a1', '', chra.codes[:2000]), "
         "SeqRecord('a2', '', chra.codes[2030:])])\n"
         "*_, counts, part, labels, mat = mg.workload()\n"
         "for n, t in (('c.csv', counts), ('p.csv', part), ('l.csv', "
         "labels), ('m.csv', mat)):\n"
         "    (d / n).write_text(t)\n"
         "runs = [\n"
         "    ['filter', '-i', 'r1.fa', '-u', 'r2.fa', '-o', 'f.fa', '-a', "
         "'-D', '2', '--device', 'cpu'],\n"
         "    ['assemb', '-i', 'r1.fa', '-u', 'r2.fa', '-o', 'a.fa', '-y', "
         "'40', '-Y', '25'],\n"
         "    ['mergeoverlaps', '-i', 'r1.fa', '-u', 'r2.fa', '-o', "
         "'mo.fa'],\n"
         "    ['scaffold', '-a', 'r1.fa', '-A', 'r2.fa', '-c', 'ctg.fa', "
         "'-o', 's.fa', '-p', '200', '--device', 'cpu'],\n"
         "    ['index', '-i', 'ctg.fa', '-o', 'ctg.kix'],\n"
         "    ['kalign', '-i', 'r1.fa', '-I', 'ctg.kix', '-o', 'm1.sam', "
         "'--device', 'cpu'],\n"
         "    ['kalign', '-i', 'r2.fa', '-I', 'ctg.kix', '-o', 'm2.sam', "
         "'--device', 'cpu'],\n"
         "    ['pescaffold', '-a', 'm1.sam', '-A', 'm2.sam', '-c', "
         "'ctg.fa', '-o', 'ps.fa'],\n"
         "    ['rnaexpr', '-i', 'c.csv', '-c', 'p.csv', '-o', 'r.csv', "
         "'--device', 'cpu'],\n"
         "    ['genmlds', '-i', 'c.csv', '-l', 'l.csv', '-o', 'g.csv'],\n"
         "    ['sarscov2ml', '-i', 'm.csv', '-o', 'x.csv', '-l', '3', '-r', "
         "'20', '--device', 'cpu']]\n"
         "for argv in runs:\n"
         "    assert cli.main(argv) == 0, argv\n", tmp_path)
    for f in ("f.fa", "a.fa", "mo.fa", "r.csv", "g.csv", "x.csv"):
        assert (tmp_path / f).read_text().count("\n") > 2, f
    for f in ("s.fa", "ps.fa"):
        assert "contigs=a1,a2" in (tmp_path / f).read_text(), f


def test_cli_pacbio_commands_with_both_blocked(tmp_path, host_library):
    """pbfilter, ecreads, pbassemb and eccontigs on CLR-like reads of a
    3 kbp genome (tools.pacbio_reads' corruption), one read folded into a
    hairpin: the hairpin split, reads corrected, one contig polished."""
    _run("import numpy as np\n"
         "from kit4b_tpu_torch import cli, dna\n"
         "from kit4b_tpu_torch.io.fasta import SeqRecord, read_seqs, "
         "write_fasta\n"
         "from kit4b_tpu_torch.tools.pacbio_reads import corrupt_pacbio\n"
         "rng = np.random.default_rng(5)\n"
         "g = rng.integers(0, 4, 3000).astype(np.uint8)\n"
         "reads = [SeqRecord(f'r{i}', '', corrupt_pacbio(g[s:s + 700], rng, "
         "ins=0.03, dele=0.02)) for i, s in enumerate(range(0, 2301, 150))]\n"
         "arm = reads[0].codes[:400]\n"
         "reads.append(SeqRecord('hp', '', np.concatenate([arm, "
         "dna.revcomp(arm)])))\n"
         "write_fasta('raw.fa', reads)\n"
         "runs = [['pbfilter', '-i', 'raw.fa', '-o', 'filt.fa', '-l', '300'],\n"
         "        ['ecreads', '-i', 'filt.fa', '-o', 'ec.fa', '-l', '500', "
         "'-L', '300', '-b', '256'],\n"
         "        ['pbassemb', '-i', 'ec.fa', '-o', 'ctg.fa', '-l', '300', "
         "'-p', '0.8'],\n"
         "        ['eccontigs', '-i', 'ctg.fa', '-r', 'ec.fa', '-o', "
         "'pol.fa']]\n"
         "for argv in runs:\n"
         "    assert cli.main(argv + ['--device', 'cpu']) == 0, argv\n"
         "names = [r.name for r in read_seqs('filt.fa')]\n"
         "assert 'hp/sub1' in names and 'hp/sub2' in names, names\n"
         "assert len(list(read_seqs('ec.fa'))) >= 10\n"
         "assert len(list(read_seqs('pol.fa'))) >= 1\n", tmp_path)


def test_cli_longtail_commands_with_both_blocked(tmp_path, host_library):
    """blitz (gapped and not), hrdx, kmerdist, benchmark 0-4, alignsbs,
    ngsqc, maploci and rnade through the CLI on the small inputs of
    `make_longtail_golden`, their outputs equal to the committed golden."""
    _run("import numpy as np\n"
         "import torch\n"
         "torch.set_num_threads(2)\n"
         "from kit4b_tpu_torch.tools import make_longtail_golden as mg\n"
         "out = mg.compute(mg.port_fns('cpu'))\n"
         "with np.load(mg.GOLDEN) as z:\n"
         "    bad = mg.differing(out, {k: z[k] for k in z.files})\n"
         "assert bad == [], bad\n"
         "assert len(out) >= 35\n", tmp_path)


def test_cli_haplotype_commands_with_both_blocked(tmp_path):
    """Every mode of callhaplotypes, pbautils, snpmarkers, snps2pgsnps,
    lochap2bed, markerseqs, repassemb, pangenome, seghaplotypes,
    gbsmapsnps and dgts through the CLI on the inputs of
    `make_haplotypes_golden`, their outputs equal to the committed golden
    (host numpy only: no index, no device)."""
    _run("import numpy as np\n"
         "from kit4b_tpu_torch.tools import make_haplotypes_golden as mg\n"
         "out = mg.compute(mg.port_fns())\n"
         "with np.load(mg.GOLDEN) as z:\n"
         "    bad = mg.differing(out, {k: z[k] for k in z.files})\n"
         "assert bad == [], bad\n"
         "assert len(out) >= 140\n", tmp_path)
