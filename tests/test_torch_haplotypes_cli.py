"""The port's `callhaplotypes`, `snpmarkers`, `pbautils`, `snps2pgsnps`,
`lochap2bed`, `markerseqs`, `repassemb`, `pangenome`, `seghaplotypes`,
`gbsmapsnps`, `dgts` and `locmarkers` commands against `python -m
kit4b_tpu`'s: every run of the haplotypes golden
(`make_haplotypes_golden.RUNS`, every mode of each command) on its seeded
inputs writes the same files, byte for byte (a .npz array by array), and
prints the same text; the error paths exit alike. `locmarkers` refuses
where the JAX package computes and then raises TypeError, and neither
writes a file. Three faults of the JAX package are held as they are,
the port copying them: `pbautils -m 1` drops the first locus of every
chromosome after the first, `lochap2bed` fails on a DiSNP row of more
than one allele combination, and PBAs that `kalign -3` wrote count as one
sample in pbautils' multi-sample modes (ROADMAP.md queue C).
"""
import shutil

import numpy as np
import pytest

from kit4b_tpu.cli import main as jax_main
from kit4b_tpu.kmer import kmarkers as jkm
from kit4b_tpu.utils import runtime as jax_runtime
from kit4b_tpu_torch import native
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.kmer import kmarkers as pkm
from kit4b_tpu_torch.kmer import pbautils2
from kit4b_tpu_torch.kmer.pba import load_pba
from kit4b_tpu_torch.tools import make_haplotypes_golden as mg

# runs whose inputs an earlier run writes
NEEDS = {"ch_m9": ["ch_m7"], "ch_m9_prune": ["ch_m7"],
         "ch_m11": ["ch_m7"], "ch_m11_none": ["ch_m7"],
         "ch_m12": ["ch_m7"], "ch_m12_none": ["ch_m8"],
         "dgts_m1": ["ch_m5"], "gbs_m1": ["gbs_m0"]}
MAINS = (("jax", jax_main), ("port", port_main))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("haplotypes_cli") / "in"
    d.mkdir()
    mg.write_inputs(mg.workload(), d)
    return d


def _outputs(main, name, src, d):
    shutil.copytree(src, d)
    fns = [mg.RUNS[n] for n in NEEDS.get(name, [])]
    if name in mg.PRE_RUNS:
        fns.append(mg.PRE_RUNS[name])
    for argv_t in fns:
        assert mg.run_cli(main, argv_t, d)[0] == 0
    before = set(p.name for p in d.iterdir())
    rc, printed = mg.run_cli(main, mg.RUNS[name], d)
    assert rc == 0
    out = {}
    mg.collect(out, name, d, before)
    return out, printed


@pytest.mark.parametrize("name", list(mg.RUNS))
def test_cli_writes_the_jax_packages_bytes(inputs, tmp_path, name):
    outs = {pkg: _outputs(main, name, inputs, tmp_path / pkg)
            for pkg, main in MAINS}
    got, want = outs["port"], outs["jax"]
    assert got[1] == want[1]
    assert sorted(got[0]) == sorted(want[0]) and got[0]
    for key, a in want[0].items():
        assert got[0][key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[0][key], a, err_msg=key)


ERRORS = {   # argv (in the inputs' directory), the exception or exit code
    "pbautils_m4_no_ref": (["pbautils", "-m", "4", "-i", "{d}/P2.pba",
                            "-o", "{d}/x.vcf"], 1),
    "pbautils_m6_no_ref": (["pbautils", "-m", "6", "-i", "{d}/P2.pba",
                            "-o", "{d}/x.vcf"], 1),
    "ch_m7_no_src": (["callhaplotypes", "-m", "7", "-c", "FA={d}/FA.pba.npz",
                      "-o", "{d}/x.csv"], SystemExit),
    "ch_m0_no_progeny": (["callhaplotypes", "-c", "FA={d}/FA.pba.npz",
                          "FB={d}/FB.pba", "-o", "{d}/x.csv"], SystemExit),
    "ch_m0_one_founder": (["callhaplotypes", "-c", "FA={d}/FA.pba.npz", "-i",
                           "{d}/P1.pba.npz", "-o", "{d}/x.csv"], 1),
    "ch_m9_empty": (["callhaplotypes", "-m", "9", "-A", "{d}/qtl.csv", "-o",
                     "{d}/x"], 1),
    "gbs_m1_columns": (["gbsmapsnps", "-m", "1", "-i", "{d}/gbs1.csv", "-I",
                        "{d}/qtl.csv", "-o", "{d}/x.csv"], 1),
    "pbautils_missing": (["pbautils", "-m", "2", "-i", "{d}/none.pba.npz",
                          "-o", "{d}/x.csv"], 1),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_cli_fails_as_the_jax_package_does(inputs, tmp_path, capsys, name):
    argv_t, want = ERRORS[name]
    errs = {}
    for pkg, main in MAINS:
        d = tmp_path / pkg
        shutil.copytree(inputs, d)
        before = {p.name for p in d.iterdir()}
        if isinstance(want, int):
            assert mg.run_cli(main, argv_t, d)[0] == want
        else:
            with pytest.raises(want) as e:
                mg.run_cli(main, argv_t, d)
            errs[pkg] = [str(e.value)]
        err = capsys.readouterr().err.splitlines()
        errs[pkg] = [ln.replace(str(d), "{d}") for ln in errs.get(pkg) or [
            ln.split(": error: ", 1)[1] for ln in err if ": error: " in ln]]
        assert errs[pkg]
        assert {p.name for p in d.iterdir()} - before <= {"x.csv", "x.vcf"}
    assert errs["port"] == errs["jax"]


def test_pbautils_m1_drops_a_locus_of_later_chromosomes(inputs, tmp_path):
    """The JAX package's `pbautils -m 1` concatenates the chromosomes'
    PBAs without the genome's separators before `save_pba` cuts them at
    the genome's starts: every chromosome after the first loses its first
    locus. The port writes the same arrays (queue C)."""
    from kit4b_tpu_torch.io.fasta import Genome
    g = Genome.load(inputs / "g.fa")
    want = pbautils2.fasta_to_pba(g)
    for pkg, main in MAINS:
        out = tmp_path / f"{pkg}.pba.npz"
        assert main(["pbautils", "-m", "1", "-i", str(inputs / "g.fa"),
                     "-o", str(out)]) == 0
        rs, chroms = load_pba(out)
        assert rs == "assembly"
        np.testing.assert_array_equal(chroms["c1"], want["c1"])
        np.testing.assert_array_equal(chroms["c2"], want["c2"][1:])


def test_lochap2bed_fails_on_two_allele_combinations(tmp_path, capsys):
    """`align/snp.py` joins a DiSNP row's counts with ';'; `lochap2bed`
    reads the first count of a '|'-joined list, so a row of two allele
    combinations stops both packages with the same error after the rows
    before it, which both write (queue C)."""
    src = tmp_path / "d.csv"
    src.write_text('"DiSNP_ID","Chrom","Loci","Alleles","Counts"\n'
                   '1,"c1","10|25","AC","7"\n'
                   '2,"c1","40|90","AC;GT","3;4"\n'
                   '3,"c1","95|99","AT","2"\n')
    out, errs = {}, {}
    for pkg, main in MAINS:
        assert mg.run_cli(main, ["lochap2bed", "-i", "{d}/d.csv", "-o",
                                 f"{{d}}/{pkg}.bed"], tmp_path) == (1, "")
        out[pkg] = (tmp_path / f"{pkg}.bed").read_bytes()
        errs[pkg] = capsys.readouterr().err.split(": error: ", 1)[1]
    assert out["port"] == out["jax"] == b"c1\t10\t26\tAC\t7\t+\n"
    assert errs["port"] == errs["jax"]
    assert "invalid literal for int()" in errs["port"]


def test_samples_of_one_readset_name_collapse(inputs, tmp_path):
    """`kalign -3` and `genpba` name every PBA's readset 'readset'; the
    multi-sample pbautils modes key samples by readset, so such PBAs count
    as one sample, the last read, in both packages (queue C)."""
    from kit4b_tpu_torch.kmer.pba import save_pba
    from kit4b_tpu_torch.io.fasta import Genome
    g = Genome.load(inputs / "g.fa")
    paths = []
    for s in ("P1", "P2"):
        chroms = load_pba(inputs / f"{s}.pba.npz")[1]
        paths.append(tmp_path / f"{s}.pba.npz")
        save_pba(paths[-1], g, np.concatenate(
            [np.append(chroms[c], np.uint8(0)) for c in g.names]))
    out = {}
    for pkg, main in MAINS:
        o = tmp_path / f"{pkg}.csv"
        assert main(["pbautils", "-m", "2", "-i", *map(str, paths), "-o",
                     str(o)]) == 0
        out[pkg] = o.read_bytes()
    assert out["port"] == out["jax"]
    rows = out["port"].decode().splitlines()
    assert rows[0].split(",")[2] == '"samples"'
    assert {r.split(",")[2] for r in rows[1:]} == {"1"}


@pytest.fixture(scope="module")
def cultivar_index(tmp_path_factory):
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    d = tmp_path_factory.mktemp("locmarkers")
    rng = np.random.default_rng(77)
    a = rng.integers(0, 4, 3_000).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, 3_000, 60)] = rng.integers(0, 4, 60)
    b[1_000:1_200] = rng.integers(0, 4, 200)
    from kit4b_tpu_torch.io.fasta import SeqRecord, write_fasta
    write_fasta(d / "g.fa", [SeqRecord("cvA_1", "", a),
                             SeqRecord("cvB_1", "", b)])
    assert port_main(["index", "-i", str(d / "g.fa"), "-o",
                      str(d / "g.kix")]) == 0
    return d


def test_locmarkers_refuses_where_jax_raises(cultivar_index, tmp_path,
                                            capsys, monkeypatch):
    """The JAX package computes the markers on its device, then raises
    TypeError on `write_markers_fasta(..., cultivar=)`; the port refuses
    before it loads the index. Neither writes a marker file."""
    monkeypatch.setattr(jax_runtime, "enable_compile_cache", lambda: None)
    argv = ["locmarkers", "-i", str(cultivar_index / "g.kix"), "-c", "A",
            "-C", "cvA_1", "-k", "24", "-K", "2"]
    out = tmp_path / "jax.fa"
    with pytest.raises(TypeError, match="cultivar"):
        jax_main(argv + ["-o", str(out)])
    assert not out.exists()
    out = tmp_path / "port.fa"
    assert port_main(argv + ["-o", str(out)]) == 1
    err = capsys.readouterr().err
    assert "TypeError" in err and "queue C" in err
    assert not out.exists()


def test_locmarkers_halves_match_at_function_level(cultivar_index,
                                                   tmp_path):
    """What `locmarkers` would write once both packages drop `cultivar=`:
    `find_cultivar_markers` on its chromosome-membership vector (the
    port's pass on the CPU here, on the card in chip_smoke.py) and
    `write_markers_fasta`, equal to the JAX package's."""
    from kit4b_tpu.index.sfx_index import SfxIndex as JSfx
    from kit4b_tpu_torch.index.sfx_index import SfxIndex as PSfx
    kix = cultivar_index / "g.kix"
    jidx, pidx = JSfx.load(kix), PSfx.load(kix)
    cc = np.array([n == "cvA_1" for n in pidx.genome.names], np.int32)
    for extend in (True, False):
        jm = jkm.find_cultivar_markers(jidx, cc, 1, kmer_len=24,
                                       min_hamming=2, extend=extend)
        pm = pkm.find_cultivar_markers(pidx, cc, 1, kmer_len=24,
                                       min_hamming=2, extend=extend,
                                       device="cpu")
        assert pm and [(m.chrom, m.start, m.length, m.seq.tobytes())
                       for m in pm] == \
            [(m.chrom, m.start, m.length, np.asarray(m.seq).tobytes())
             for m in jm]
        jkm.write_markers_fasta(tmp_path / "j.fa", jm)
        pkm.write_markers_fasta(tmp_path / "p.fa", pm)
        assert (tmp_path / "p.fa").read_bytes() == \
            (tmp_path / "j.fa").read_bytes()
