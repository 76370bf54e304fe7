"""Shared set-up of the benchmark's tests: BENCHMARK.json, each cell shrunk
to a size the CPU runs in seconds, and the fixture that skips a card-only
test where there is no card."""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("hammings.yeast_r64.k25_node1of4",
         "kalign_se.ecoli_k12.illumina100_30x",
         "hammings.yeast_r64.k25_restricted3")


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def all_cells() -> dict:
    """BENCHMARK.json with the cells, metrics and configuration of
    `kbench/held_back.json` added, so the tests reach every job."""
    bench = load_bench()
    held = json.loads((ROOT / "kbench" / "held_back.json").read_text())
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[k] = bench[k] + held[k]
    return bench


def tiny(name: str):
    """(bench, cell, config, traffic) of cell `name`, shrunk: three short
    chromosomes with 200 bp copies, or a 20 kbp genome with 3,000 reads in
    batches of 1,024."""
    from kbench import run
    bench = all_cells()
    cell, config, traffic = run.cell_spec(bench, name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if traffic["job"] == "kalign_se":
        config["genome"]["length"] = 20_000
        traffic["reads"]["n_reads"] = 3_000
        traffic.update(batch_size=1_024, check_reads=600)
    else:
        config["genome"].update(names=["a", "b", "c"],
                                lengths=[2_000, 2_500, 2_200], copies=4,
                                copy_len=200, source_window=1_500, n_runs=2)
        traffic.update(check_random=300, check_planted=80)
        if "check_n_runs" in traffic:
            traffic["check_n_runs"] = 20
    return bench, cell, config, traffic


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)
