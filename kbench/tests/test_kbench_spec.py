"""BENCHMARK.json against the rules of its format, the cells' files found
by name, and no module of the benchmark importing JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, all_cells, load_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "kit4b_tpu"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


BENCHES = {"BENCHMARK.json": load_bench,
           "with the held-back cells": all_cells}


@pytest.mark.parametrize("which", BENCHES)
def test_keys_names_and_lengths(which):
    b = BENCHES[which]()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
               and (ROOT / p).is_dir() for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for section, keys in KEYS.items():
        names = [e["name"] for e in b[section]]
        assert len(names) == len(set(names)), section
        for e in b[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
        if section == "configs":
            for e in b[section]:
                assert _line(e["source"]) and len(e["reduced"]) <= 16
                assert all(NAME.match(k) for k in e["reduced"])


@pytest.mark.parametrize("which", BENCHES)
def test_bounds_and_sources(which):
    b = BENCHES[which]()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


@pytest.mark.parametrize("which", BENCHES)
def test_every_cell_reports_its_metrics(which):
    from kbench import run
    b = BENCHES[which]()
    names = [w["name"] for w in b["workloads"]]
    # the cells are BENCHMARK.json's, then the held-back ones, and they
    # hold every cell the tiny runs of the other tests reach
    held = json.loads((ROOT / "kbench" / "held_back.json").read_text())
    benched = [w["name"] for w in load_bench()["workloads"]]
    held = [w["name"] for w in held["workloads"]]
    assert names == benched + (held if which != "BENCHMARK.json" else [])
    assert set(CELLS) <= set(benched + held)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        got = run.cell_metrics(b, w, False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        layer = run.cell_metrics(b, w, True)
        assert layer, w["name"]
        for m in layer:
            assert w["name"] in e2e[m["moves"]].get("workloads", names)
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    assert {c["name"] for c in b["configs"]} == \
        {w["config"] for w in b["workloads"]}


def test_run_seconds_fit_a_check_of_24_cells():
    rs = load_bench()["run_seconds"]
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cells_files_are_found_by_name(name):
    from kbench import run
    b = all_cells()
    cell, config, traffic = run.cell_spec(b, name)
    assert config["name"] == cell["config"]
    entry = next(c for c in b["configs"] if c["name"] == cell["config"])
    assert entry["file"].startswith("kbench/configs/")
    assert entry["source"] == config["source"]
    assert entry["reduced"] == config["reduced"]
    assert (ROOT / "kbench" / "jobs" / f"{traffic['job']}.py").exists()
    assert (ROOT / "kbench" / "reference").is_dir()
    assert traffic["rate_metric"] in {m["name"] for m in b["end_to_end"]}
    for m in run.cell_metrics(b, cell, True):
        assert callable(run.metric_reader(m["name"]))


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "kbench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    # kit4b_tpu_torch begins with kit4b_tpu: names are compared whole
    assert "kit4b_tpu_torch" not in FORBIDDEN


def test_importing_the_benchmark_loads_no_jax():
    code = ("import sys, importlib, pkgutil, kbench, kbench.run, "
            "kbench.control\n"
            "for m in pkgutil.walk_packages(kbench.__path__, 'kbench.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import kbench.jobs.kalign_se, kbench.jobs.hammings_node, "
            "kbench.jobs.hammings_restricted\n"
            "import kit4b_tpu_torch.align.kalign, kit4b_tpu_torch.kmer."
            "hammings\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'kit4b_tpu'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compare_whole_names():
    from kbench import run
    assert run.forbidden_modules(["kit4b_tpu_torch", "kit4b_tpu_torch.cli",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "kit4b_tpu.cli", "flax"]) \
        == ["flax", "jax.numpy", "kit4b_tpu.cli"]


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "kbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
