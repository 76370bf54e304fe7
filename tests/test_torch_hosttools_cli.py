"""The port's alignment-block, region, RAD-seq, loci-statistics,
DNA-structure and GO commands against `python -m kit4b_tpu`'s: each of
the 40 commands, in its first run of the host-tools golden
(`make_hosttools_golden.RUNS`) on its seeded inputs, writes the same files
(text byte for byte, a .npz array by array) and prints the same text
(tests/test_torch_hosttools_golden.py holds every run, each mode and each
flag that picks another code path, to the golden through both packages);
the error paths (bad modes and formats, missing files, inputs of the
wrong kind) exit, or raise, alike. Five faults of the JAX package are held
as they are, the port copying them (ROADMAP.md queue C): `remaploci`
anchors a locus inside a '-' feature at the image of its start, so the
remapped interval runs the wrong way; `dnasitepotential` and
`rnasitepotential` skip a read whose octamer ends at its chromosome's
end; `goassoc` orders terms of equal p-value by Python's string hashing,
so the order changes with PYTHONHASHSEED; `radseq` takes a column's VCF
REF and ALT from `np.argsort`, whose order among equal counts is numpy's
and the CPU's, while the stack's consensus takes the first of them;
`prednucleosomes -m 0` takes |TLEN| of both mates, so a pair's second
mate adds a dyad |TLEN|/2 past its own start, about 100 bp downstream of
the fragment's centre.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.tools import make_hosttools_golden as mg

MAINS = (("jax", jax_main), ("port", port_main))
REPO = Path(__file__).resolve().parent.parent
FIRST = {}   # command -> the name of its first run
for _name, _argv in mg.RUNS.items():
    FIRST.setdefault(_argv[0], _name)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hosttools_cli") / "in"
    d.mkdir()
    mg.write_inputs(mg.workload(), d)
    return d


def _outputs(main, name, src, d):
    shutil.copytree(src, d)
    before = mg.files(d)
    rc, printed = mg.run_cli(main, mg.RUNS[name], d)
    assert rc == 0
    out = {}
    mg.collect(out, name, d, before)
    return out, printed


@pytest.mark.parametrize("cmd", sorted(FIRST))
def test_cli_writes_the_jax_packages_bytes(inputs, tmp_path, cmd):
    name = FIRST[cmd]
    outs = {pkg: _outputs(main, name, inputs, tmp_path / pkg)
            for pkg, main in MAINS}
    got, want = outs["port"], outs["jax"]
    assert got[1] == want[1]
    assert sorted(got[0]) == sorted(want[0]) and (got[0] or got[1])
    for key, a in want[0].items():
        assert got[0][key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[0][key], a, err_msg=key)


ERRORS = {   # argv (in the inputs' directory), the exception or exit code
    "genmafalgn_missing": (["genmafalgn", "-i", "{d}/none.maf", "-o",
                            "{d}/x.npz"], 1),
    "hypers_not_algn": (["hypers", "-i", "{d}/g.kix", "-o", "{d}/x.csv"],
                        KeyError),
    "gendeseq_unnamed": (["gendeseq", "-s", "{d}/a.sam", "-b",
                          "{d}/feat.bed", "-o", "{d}/x.csv"], 1),
    "radseq_missing": (["radseq", "-i", "{d}/none.fa", "-o", "{d}/x.fa"],
                       1),
    "wigutils_bad_mode": (["wigutils", "-i", "{d}/a.wig", "-o",
                           "{d}/x.wig", "-m", "merge"], SystemExit),
    "wigutils_bad_op": (["wigutils", "-i", "{d}/a.wig", "{d}/b.wig", "-o",
                         "{d}/x.wig", "-p", "median"], SystemExit),
    "wigutils_headless": (["wigutils", "-i", "{d}/bad.wig", "-o",
                           "{d}/x.wig"], KeyError),
    "goassoc_missing": (["goassoc", "-i", "{d}/sample.txt", "-a",
                         "{d}/none.gaf", "-o", "{d}/x.csv"], 1),
    "fasta2struct_bad_prop": (["fasta2struct", "-i", "{d}/struct.fa", "-I",
                               "{d}/oct.csv", "-p", "bend", "-o",
                               "{d}/x.csv"], 1),
    "prednuc_bad_format": (["prednucleosomes", "-i", "{d}/mnase.sam", "-M",
                            "5", "-o", "{d}/x.csv"], KeyError),
    "loci2dist_bad_strand": (["loci2dist", "-i", "{d}/loci.csv", "-s", "3",
                              "-o", "{d}/x.csv"], KeyError),
    "genzygosity_missing": (["genzygosity", "-i", "{d}/none.kix", "-o",
                             "{d}/x.csv"], 1),
    "predconfnucs_no_groove": (["predconfnucs", "-i", "{d}/struct.fa", "-I",
                                "{d}/oct2.csv", "-o", "{d}/x.csv"],
                               KeyError),
    "centroid_even_nmer": (["gencentroidmetrics", "-m", "1", "-i",
                            "{d}/g.fa", "-o", "{d}/x.csv", "-n", "4"],
                           AssertionError),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_cli_fails_as_the_jax_package_does(inputs, tmp_path, capsys, name):
    argv_t, want = ERRORS[name]
    errs = {}
    for pkg, main in MAINS:
        d = tmp_path / pkg
        shutil.copytree(inputs, d)
        before = mg.files(d)
        if isinstance(want, int):
            assert mg.run_cli(main, argv_t, d)[0] == want
        else:
            with pytest.raises(want) as e:
                mg.run_cli(main, argv_t, d)
            errs[pkg] = [type(e.value).__name__, str(e.value)]
        err = capsys.readouterr().err.splitlines()
        errs[pkg] = [ln.replace(str(d), "{d}") for ln in errs.get(pkg) or [
            ln.split(": error: ", 1)[1] for ln in err if ": error: " in ln]]
        assert errs[pkg]
        assert mg.files(d) - before <= {"x.csv", "x.fa", "x.wig", "x.npz"}
    assert errs["port"] == errs["jax"]


def test_remaploci_runs_minus_strand_loci_from_their_start(tmp_path):
    """A locus [4000, 4100) inside c1's '-' feature [3900, 4400) named
    scafB has the image [300, 400) on scafB; both packages write
    [399, 499): the start's image, then the length added (BED), and POS
    the start's image with SEQ and FLAG as they were (SAM) (queue C)."""
    (tmp_path / "remap.bed").write_text("c1\t3900\t4400\tscafB\t0\t-\n")
    (tmp_path / "in.bed").write_text("c1\t4000\t4100\tl1\t0\t+\n")
    (tmp_path / "in.sam").write_text(
        "@SQ\tSN:c1\tLN:5000\n"
        "r1\t0\tc1\t4001\t60\t5M\t*\t0\t0\tACGTT\tIIIII\n")
    for pkg, main in MAINS:
        for src, ext in (("in.bed", "bed"), ("in.sam", "sam")):
            out = tmp_path / f"{pkg}.{ext}"
            assert main(["remaploci", "-i", str(tmp_path / src), "-I",
                         str(tmp_path / "remap.bed"), "-o", str(out)]) == 0
        assert (tmp_path / f"{pkg}.bed").read_text() == \
            "scafB\t399\t499\tl1\t0\t+\n"
        assert (tmp_path / f"{pkg}.sam").read_text() == \
            "r1\t0\tscafB\t400\t60\t5M\t*\t0\t0\tACGTT\tIIIII\n"


def test_site_potential_skips_the_octamer_at_a_chromosome_end():
    """A '+' read starting 4 bases before its chromosome's end has its
    octamer [len - 8, len) inside the chromosome; `site_potential` takes
    `ofs + 8 >= len` as out of bounds and drops it, in both packages (queue
    C), while the read one base earlier counts."""
    from kit4b_tpu.io.fasta import Genome as JGenome, SeqRecord as JRec
    from kit4b_tpu.tools.structextra import site_potential as jsp
    from kit4b_tpu_torch import dna
    from kit4b_tpu_torch.io.fasta import Genome as PGenome, SeqRecord as PRec
    from kit4b_tpu_torch.tools.structextra import site_potential as psp
    seq = dna.encode("ACGTACGTTTGCAAGGCCTTAAGCATGCAT")
    n = len(seq)
    reads = [{"chrom": "c", "start": s, "end": s + 9, "strand": "+"}
             for s in (n - 4, n - 5)]
    res = {}
    for name, G, R, fn in (("jax", JGenome, JRec, jsp),
                           ("port", PGenome, PRec, psp)):
        g = G.from_records([R("c", "", seq)])
        res[name] = {mer: site for mer, _, site, _ in fn(reads, g)}
    assert res["port"] == res["jax"]
    assert res["port"][dna.decode(seq[n - 8:])] == 0
    assert res["port"][dna.decode(seq[n - 9:n - 1])] == 1


GO_TIES = r"""
import json, sys, types
sys.path.insert(0, {repo!r})
stats = types.ModuleType("scipy.stats")
stats.hypergeom = types.SimpleNamespace(sf=lambda *a: 0.5)
sys.modules["scipy"] = types.ModuleType("scipy")
sys.modules["scipy.stats"] = stats
from kit4b_tpu.tools import go as jgo
from kit4b_tpu_torch.tools import go as pgo
assoc = {{f"gene{{i}}": {{f"GO:{{t:07d}}" for t in range(1, 7)}}
          for i in range(4)}}
sample = ["gene0", "gene1"]
print(json.dumps([[r.goid for r in m.enrich(sample, list(assoc), assoc)]
                  for m in (jgo, pgo)]))
"""


def test_goassoc_orders_tied_terms_by_string_hash():
    """Six terms with the same counts tie in p-value; `enrich` sorts by
    p-value alone, so they keep the order in which iterating sets of gene
    and GO id strings meets them, which follows PYTHONHASHSEED: the same
    in both packages under one seed, another under another of seeds 1-3
    (queue C; scipy is stubbed in the child processes, every p-value
    0.5)."""
    orders = set()
    for seed in range(1, 4):
        env = dict(os.environ, PYTHONHASHSEED=str(seed))
        out = subprocess.run([sys.executable, "-c",
                              GO_TIES.format(repo=str(REPO))], env=env,
                             capture_output=True, text=True, check=True)
        jax_order, port_order = json.loads(out.stdout)
        assert port_order == jax_order
        assert sorted(port_order) == [f"GO:{t:07d}" for t in range(1, 7)]
        orders.add(tuple(port_order))
    assert len(orders) > 1


def test_radseq_ref_follows_argsort_where_the_consensus_takes_argmax():
    """Ten reads of one stack split 5/5 between G and T at column 40: the
    consensus (`argmax`, the first maximum) reads G there, the VCF REF and
    ALT are `np.argsort(-counts)[:2]`, which is not stable: its order of
    the tied G and T is numpy's for this CPU. Both packages give the same
    stack, with REF as that argsort gives it (queue C)."""
    from kit4b_tpu.assembly import radseq as jrs
    from kit4b_tpu.io.fasta import SeqRecord as JRec
    from kit4b_tpu_torch.assembly import radseq as prs
    from kit4b_tpu_torch.io.fasta import SeqRecord as PRec
    rng = np.random.default_rng(17)
    base = rng.integers(0, 4, 70).astype(np.uint8)
    base[40] = 2
    reads = []
    for k in range(10):
        r = base.copy()
        r[40] = 2 if k % 2 else 3
        reads.append(r)
    got = {}
    for name, mod, R in (("jax", jrs, JRec), ("port", prs, PRec)):
        st = mod.stack_p1([R(f"r{k}", "", r) for k, r in enumerate(reads)],
                          min_depth=5)
        assert len(st) == 1
        got[name] = (st[0].consensus.tolist(), st[0].variants)
    assert got["port"] == got["jax"]
    cons, variants = got["port"]
    order = np.argsort(-np.array([0, 0, 5, 5], np.int32))
    assert cons[40] == 2
    assert variants == [(40, int(order[0]), int(order[1]), 10, 5)]


def test_prednucleosomes_counts_the_second_mate_off_centre(tmp_path):
    """Four 147 bp fragments [1000, 1147) known by their second mates only
    (FLAG 147, POS 1098, TLEN -147): mode 0 takes |TLEN| and the mate's own
    start, so both packages call the dyad at 1097 + 73 = 1170, 97 bp past
    the fragments' centre 1073 (queue C)."""
    sam = tmp_path / "m.sam"
    sam.write_text("@SQ\tSN:c1\tLN:3000\n" + "".join(
        f"f{k}\t147\tc1\t1098\t60\t50M\t=\t1001\t-147\t{'A' * 50}\t"
        f"{'I' * 50}\n" for k in range(4)))
    for pkg, main in MAINS:
        out = tmp_path / f"{pkg}.csv"
        assert main(["prednucleosomes", "-i", str(sam), "-M", "2", "-o",
                     str(out)]) == 0
        assert out.read_text() == '"Chrom","Dyad","Score"\n"c1",1170,4.00\n'
