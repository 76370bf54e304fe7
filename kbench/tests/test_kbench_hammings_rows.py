"""The streamed-rows hammings cell (`hammings.grch38.k25_node2849of4096`):
its entries and files, a run at a tiny size on the CPU, its per-layer
readers, the faults its check catches and the control that must fail.

At the tiny size the genome is three chromosomes of 6 kbp, node 7 of 18
takes partner columns [6144, 7168), and a unit is a block of 2,048 own
rows from row 4,608, so that units 0 and 1 meet inside the span, as units
0 and 1 of the cell meet at 2^31 inside node 2849's span."""
from __future__ import annotations

import copy
import json
import time

import numpy as np
import pytest
import torch

from kbench import control, run
from kbench.jobs import hammings_rows as job_mod
from kbench.reference import hammings_rows as ref
from conftest import ROOT, load_bench

CELL = "hammings.grch38.k25_node2849of4096"
METRICS = ("minmm_roofline", "device_idle_pct.hammings",
           "idle_between_blocks_ms.hammings_rows")
CPU = torch.device("cpu")
SEED = 2**31 + 123


def tiny():
    """(bench, cell, config, traffic) of the cell, shrunk."""
    bench = load_bench()
    cell, config, traffic = run.cell_spec(bench, CELL)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["genome"].update(names=["a", "b", "c"],
                            lengths=[6_000, 6_000, 6_000], copies=4,
                            copy_len=200, source_window=1_500, n_runs=4)
    traffic.update(node=7, numnodes=18, first_row=4_608, unit_rows=2_048,
                   check_random=200, check_self=200, check_copies=100)
    return bench, cell, config, traffic


def _run(trace=False, seconds=0.2):
    bench, cell, config, traffic = tiny()
    return run.run_cell(bench, cell, config, traffic, SEED, seconds, trace,
                        CPU, time.perf_counter())


def test_the_entries_and_the_files_of_the_cell():
    b = load_bench()
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    assert cell == {"name": CELL, "config": "grch38_k25",
                    "traffic": "hammings_rows_node2849of4096", "chips": 1,
                    "why": cell["why"]} and len(cell["why"]) <= 200
    entry = next(c for c in b["configs"] if c["name"] == "grch38_k25")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == "grch38_k25"
    assert entry["source"] == config["source"]
    assert entry["reduced"] == config["reduced"] == ["own_rows"]
    assert "own_rows" in config and config["K"] == 25 and config["antisense"]
    assert len(config["genome"]["lengths"]) == 24
    assert sum(config["genome"]["lengths"]) == 3_088_269_832
    _, _, traffic = run.cell_spec(b, CELL)
    assert traffic["job"] == "hammings_rows"
    assert (ROOT / "kbench" / "jobs" / "hammings_rows.py").exists()
    rate = next(m for m in b["end_to_end"]
                if m["name"] == traffic["rate_metric"])
    assert CELL in rate["workloads"]
    assert {m["name"] for m in run.cell_metrics(b, cell, False)} == \
        {"hammings_rows_per_s", "setup_s"}
    layer = run.cell_metrics(b, cell, True)
    assert tuple(m["name"] for m in layer) == METRICS
    for m in layer:
        # the kernel's roofline and the device's idle share are the yeast
        # cell's readers; the idle between blocks reads this cell alone
        assert m["workloads"][-1] == CELL and \
            m["moves"] == "hammings_rows_per_s"
        assert callable(run.metric_reader(m["name"]))
    assert layer[-1]["workloads"] == [CELL]


def test_the_traffic_meets_2_31_inside_the_nodes_span():
    b = load_bench()
    _, config, traffic = run.cell_spec(b, CELL)
    G = sum(config["genome"]["lengths"]) + 24
    Gp, c0, c1 = ref.node_columns(G, traffic["node"] - 1,
                                  traffic["numnodes"])
    assert (Gp, c0, c1) == (3_088_271_360, 2_147_313_664, 2_148_067_328)
    first, rows = traffic["first_row"], traffic["unit_rows"]
    assert first + rows == 1 << 31 and c0 < 1 << 31 < c1 <= first + 2 * rows
    assert (Gp - first) // rows == 57


def test_the_sound_run_is_correct_and_checks_each_kind():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {
        "blocks_length_wrong", "blocks_run_again_differing",
        "random_rows_differing", "self_rows_differing",
        "copies_rows_differing"}
    assert out["attempted"] == 2_048 * len(out["run"]["unit_ends_s"])
    assert set(out["metrics"]) == {"hammings_rows_per_s", "setup_s"}


def test_a_traced_run_reads_the_cells_per_layer_metrics():
    """On the CPU the device runs nothing: the idle share reads 100, the
    roofline nothing, the idle between blocks the whole of its spans."""
    out = _run(trace=True)
    assert out["correct"]
    got = out["metrics"]
    assert set(got) == set(METRICS[1:])
    assert got["device_idle_pct.hammings"]["value"] == 100.0
    assert got["idle_between_blocks_ms.hammings_rows"]["value"] > 0


def test_the_job_plants_copies_of_both_strands_into_the_first_units():
    _, _, config, traffic = tiny()
    job = job_mod.Job(config, traffic, SEED, CPU, "")
    assert [s for _, _, s in job.copies] == [True, False] * 4
    for u, (d, L, _) in enumerate(job.copies):
        a, b = job.slot_rows(u // 2)
        assert a <= d and d + L <= b and L == 200
        assert not job_mod.intervals_hit(d, d + L, [(job.c0 - L, job.c1)])
    pos = np.concatenate([np.arange(d, d + L - 24) for d, L, _ in
                          job.copies])
    near = job.reference(pos)
    assert (near <= 4).all()
    # the reverse strand's copies reach their partners only through it
    assert (job.reference(pos, control=True) > 4).sum() > len(pos) // 3


def _broken(monkeypatch, fault):
    from kit4b_tpu_torch.kernels.minmm import NEG
    from kit4b_tpu_torch.kmer import hammings_mxu as hm
    real_minmm, real_rows = hm.minmm, hm.HammingsNode.rows
    if fault == "a dropped strand":
        def minmm(W_own, W_part, **kw):
            out = real_minmm(W_own, W_part, **kw)
            return out if kw["diag"] else torch.full_like(out, NEG)
        monkeypatch.setattr(hm, "minmm", minmm)
    elif fault == "a block off by one row":
        monkeypatch.setattr(hm.HammingsNode, "rows",
                            lambda self, r0, r1: real_rows(self, r0 + 1,
                                                           r1 + 1))
    else:
        # the column base of the self-pair test with its high bits lost, as
        # a 32-bit column base loses them past 2^31; at the tiny genome's
        # size its bits from 2^11 up: on the plain version the self pairs
        # follow row_base, so the shift moves them
        def minmm(W_own, W_part, **kw):
            lost = kw["col_base"] - (kw["col_base"] & 0x7FF)
            return real_minmm(W_own, W_part,
                              **dict(kw, row_base=kw["row_base"] + lost))
        monkeypatch.setattr(hm, "minmm", minmm)


@pytest.mark.parametrize("fault", ["a dropped strand",
                                   "a block off by one row",
                                   "a column base cut to 32 bits"])
def test_faults_are_caught(monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = _run()
    assert not out["correct"], out["checks"]


def test_the_control_fails_at_the_tiny_size():
    bench, _, config, traffic = tiny()
    got = control.control_readings(bench, CELL, SEED, CPU, config, traffic)
    assert any(v > lim for v, lim in got.values()), got


@pytest.mark.cuda
def test_cell_is_correct_on_the_card(card):
    bench, cell, config, traffic = tiny()
    out = run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.5, True,
                       card, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["metrics"]["minmm_roofline"]["value"] > 0


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    got = control.control_readings(load_bench(), CELL, 2**31 + 6, card)
    assert any(v > lim for v, lim in got.values()), got
