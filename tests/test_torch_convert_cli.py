"""The port's converters and file tools against `python -m kit4b_tpu`'s:
every run of the converters golden (`make_convert_golden.RUNS`, each mode
and each flag that picks another code path) on its seeded inputs writes
the same files (text byte for byte, a .npz array by array, a SQLite
database by its dump) and prints the same text; the error paths exit, or
raise, alike. The port's parser holds every subcommand of the JAX
package's, each with its flags. Three faults of the JAX package are held
as they are, the port copying them: `snpm2sqlite` reads snpmarkers' own CSV with its
MarkerID and purity columns as cultivars, `de2sqlite` reads rnade's CSV
without its fold change and Pearson, and `genbioseq`/`genbiobed` write
`<name>.npz` where `-o` names another file (ROADMAP.md queue C).
"""
import argparse
import re
import shutil
import sqlite3

import numpy as np
import pytest

from kit4b_tpu import cli as jax_cli
from kit4b_tpu.cli import main as jax_main
from kit4b_tpu_torch import cli as port_cli
from kit4b_tpu_torch.cli import main as port_main
from kit4b_tpu_torch.tools import make_convert_golden as mg

MAINS = (("jax", jax_main), ("port", port_main))
# the commands that take the port's own `--device {cuda,cpu}`
DEVICE_CMDS = {"hammings", "kalign", "genpba", "kmarkers", "filter",
               "scaffold", "rnaexpr", "sarscov2ml", "ecreads", "pbfilter",
               "pbassemb", "eccontigs", "blitz", "alignsbs"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert_cli") / "in"
    d.mkdir()
    mg.write_inputs(mg.workload(), d)
    return d


def _subcommands(ap):
    return next(a.choices for a in ap._actions
                if isinstance(a, argparse._SubParsersAction))


def test_parser_has_every_jax_subcommand():
    """Both parsers hold the same 112 subcommands, each with the same
    flags (letters, destinations, defaults, nargs, types, choices) and
    `kind`; the port adds `--device` to the commands that use a device,
    and to no other."""
    js = _subcommands(jax_cli.build_parser())
    ps = _subcommands(port_cli.build_parser())
    assert len(js) == len(ps) == 112
    assert set(ps) == set(js)

    def flags(p):
        return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                       a.nargs, a.required, repr(a.type), a.const,
                       repr(a.choices))
                      for a in p._actions if a.option_strings)
    device = (("--device",), "device", "'cuda'", None, False, "None", None,
              "('cuda', 'cpu')")
    for name in js:
        got = flags(ps[name])
        assert (device in got) == (name in DEVICE_CMDS), name
        assert [f for f in got if f != device] == flags(js[name]), name
        assert ps[name].get_default("kind") == js[name].get_default("kind")


def _outputs(main, name, src, d):
    shutil.copytree(src, d)
    before = mg.files(d)
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
    assert sorted(got[0]) == sorted(want[0]) and (got[0] or got[1])
    for key, a in want[0].items():
        assert got[0][key].dtype == a.dtype, key
        np.testing.assert_array_equal(got[0][key], a, err_msg=key)


ERRORS = {   # argv (in the inputs' directory), the exception or exit code
    "agp_missing_contig": (["gengenomefromagp", "-i", "{d}/ctg.fa", "-I",
                            "{d}/bad.agp", "-o", "{d}/x.fa"], 1),
    "fasta2nxx_empty": (["fasta2nxx", "-i", "{d}/empty.fa"], 1),
    "csv2fasta_no_genome": (["csv2fasta", "-i", "{d}/loci.csv", "-g",
                             "{d}/none.fa", "-o", "{d}/x.fa"], 1),
    "usim_de_over_100": (["usimdiffexpr", "-o", "{d}/x.csv", "-t", "50",
                          "-e", "150"], 1),
    "csvfilter_bad_region": (["csvfilter", "-i", "{d}/os1.csv", "-o",
                              "{d}/x.csv", "-R", "4,x"], 1),
    "csvmerge_no_rel": (["csvmerge", "-i", "{d}/loci.csv", "-I",
                         "{d}/none.csv", "-o", "{d}/x.csv"], 1),
    "pcf_no_match": (["processcsvfiles", "-i", "{d}/loci.csv", "-I",
                      "{d}/none*.csv", "-o", "{d}/x.csv"], 1),
    "psl2csv_missing": (["psl2csv", "-i", "{d}/none.psl", "-o",
                         "{d}/x.csv"], 1),
    "bedfilter_strand_3": (["bedfilter", "-s", "3", "-i", "{d}/feat.bed",
                            "-o", "{d}/x.bed"], KeyError),
    "bedmerge_strand_3": (["bedmerge", "-s", "3", "-i", "{d}/feat.bed",
                           "-o", "{d}/x.bed"], KeyError),
    "snps2sqlite_not_snps": (["snps2sqlite", "-i", "{d}/loci.csv", "-o",
                              "{d}/x.db"], KeyError),
    "xfasta_bad_pattern": (["xfasta", "-i", "{d}/reads.fa", "-o",
                            "{d}/x.fa", "-p", "(p"], re.error),
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
        assert mg.files(d) - before <= {"x.csv", "x.fa", "x.bed", "x.db"}
    assert errs["port"] == errs["jax"]


def _table(db, sql):
    con = sqlite3.connect(db)
    try:
        return con.execute(sql).fetchall()
    finally:
        con.close()


def test_snpm2sqlite_reads_snpmarkers_columns_as_cultivars(inputs,
                                                          tmp_path):
    """`markers_to_sqlite` takes every column but Chrom, Loci, RefBase and
    `<cultivar>_Score` as a cultivar; kmer/snpmarkers.py writes MarkerID
    and `<cultivar>_purity` columns, so both packages store them as
    cultivars, every score 0 (queue C)."""
    for pkg, main in MAINS:
        db = tmp_path / f"{pkg}.db"
        assert main(["snpm2sqlite", "-i", str(inputs / "markers.csv"), "-o",
                     str(db)]) == 0
        assert _table(db, "SELECT CultName FROM TblCults ORDER BY CultID") \
            == [("MarkerID",), ("A",), ("A_purity",), ("B",), ("B_purity",)]
        assert _table(db, "SELECT DISTINCT Score FROM TblMarkers") == [(0,)]
        assert _table(db, "SELECT COUNT(*) FROM TblMarkers") == [(50,)]


def test_de2sqlite_reads_rnade_csv_without_fold_or_pearson(inputs,
                                                          tmp_path):
    """rnade's CSV names its columns Feat, ObsFoldChange and ObsPearson;
    `de_to_sqlite` reads FoldChange, PearsonCtrl and PearsonExpr, so every
    rnade row goes in with 0.0 for all three, the feature and the class
    number kept (queue C)."""
    for pkg, main in MAINS:
        db = tmp_path / f"{pkg}.db"
        assert main(["de2sqlite", "-i", str(inputs / "rnade.csv"), "-o",
                     str(db)]) == 0
        rows = _table(db, "SELECT Feature, Classification, FoldChange, "
                          "PearsonCtrl, PearsonExpr FROM TblDE")
        assert rows == [(f"g{i}", str(1 + i % 4), 0.0, 0.0, 0.0)
                        for i in range(5)]


@pytest.mark.parametrize("cmd,src", [("genbioseq", "g.fa"),
                                     ("genbiobed", "feat.bed")])
def test_bioseq_and_biobed_names_gain_npz(inputs, tmp_path, cmd, src):
    """`np.savez_compressed` appends .npz to a name without it, so
    `genbioseq -o g.seq` writes g.seq.npz and no g.seq, in both packages
    (queue C); the arrays are equal."""
    out = {}
    for pkg, main in MAINS:
        d = tmp_path / pkg
        d.mkdir()
        assert main([cmd, "-i", str(inputs / src), "-o",
                     str(d / "out.seq")]) == 0
        assert sorted(p.name for p in d.iterdir()) == ["out.seq.npz"]
        out[pkg] = mg.npz_arrays(d / "out.seq.npz")
    assert sorted(out["port"]) == sorted(out["jax"])
    for k, a in out["jax"].items():
        np.testing.assert_array_equal(out["port"][k], a, err_msg=k)
