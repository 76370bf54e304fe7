"""The streamed-rows hammings cell at K 100
(`hammings.grch38.k100_node5697of8192`, the kernel's Cw 512 rows): its
entries and files, the traffic's meeting with 2^31, a run at a tiny size on
the CPU, the faults its check catches, the control that must fail, and
the one-hot build's reader `onehot_ms_per_block.hammings_rows`.

At the tiny size the genome is three chromosomes of 6 kbp, node 7 of 18
takes partner columns [6144, 7168), and a unit is a block of 2,048 own
rows from row 4,608, so that units 0 and 1 meet inside the span, as units
0 and 1 of the cell meet at 2^31 inside node 5697's span."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from kbench import control, run
from kbench.reference import hammings_rows as ref
from kbench.trace import Trace
from conftest import ROOT, load_bench
from test_kbench_hammings_rows import _broken

CELL = "hammings.grch38.k100_node5697of8192"
K25_CELL = "hammings.grch38.k25_node2849of4096"
ONEHOT = "onehot_ms_per_block.hammings_rows"
METRICS = ("minmm_roofline", "device_idle_pct.hammings",
           "idle_between_blocks_ms.hammings_rows", ONEHOT)
CPU = torch.device("cpu")
SEED = 2**31 + 321


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


def _run(trace=False, seconds=0.2, device=CPU, seed=SEED):
    bench, cell, config, traffic = tiny()
    return run.run_cell(bench, cell, config, traffic, seed, seconds, trace,
                        device, time.perf_counter())


def test_the_entries_and_the_files_of_the_cell():
    b = load_bench()
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    assert cell == {"name": CELL, "config": "grch38_k100",
                    "traffic": "hammings_rows_node5697of8192", "chips": 1,
                    "why": cell["why"]} and len(cell["why"]) <= 200
    entry = next(c for c in b["configs"] if c["name"] == "grch38_k100")
    config = json.loads((ROOT / entry["file"]).read_text())
    k25 = json.loads((ROOT / "kbench/configs/grch38_k25.json").read_text())
    assert config["name"] == "grch38_k100"
    assert entry["source"] == config["source"] == "https://bismap.hoffmanlab.org/"
    assert config["source"] != k25["source"]
    assert "GCF_000001405.40" in config["deployment"]
    assert entry["reduced"] == config["reduced"] == ["own_rows"]
    assert "own_rows" in config and config["K"] == 100 and config["antisense"]
    assert config["genome"] == k25["genome"]
    assert sum(config["genome"]["lengths"]) == 3_088_269_832
    assert "Umap" in config["deployment"] and "GEM" in config["deployment"]
    _, _, traffic = run.cell_spec(b, CELL)
    assert traffic["job"] == "hammings_rows"
    assert {m["name"] for m in run.cell_metrics(b, cell, False)} == \
        {"hammings_rows_per_s", "setup_s"}
    layer = run.cell_metrics(b, cell, True)
    assert tuple(m["name"] for m in layer) == METRICS
    for m in layer:
        assert m["workloads"][-1] == CELL and \
            m["moves"] == "hammings_rows_per_s"
        assert callable(run.metric_reader(m["name"]))
    onehot = layer[-1]
    assert onehot == {"name": ONEHOT, "unit": "ms", "better": "lower",
                      "source": "program_span", "layer": "one-hot build",
                      "moves": "hammings_rows_per_s",
                      "workloads": [K25_CELL, CELL]}
    assert b["per_layer"][-1] == onehot


def test_the_traffic_meets_2_31_inside_the_nodes_span():
    _, config, traffic = run.cell_spec(load_bench(), CELL)
    G = sum(config["genome"]["lengths"]) + 24
    Gp, c0, c1 = ref.node_columns(G, traffic["node"] - 1,
                                  traffic["numnodes"])
    assert (Gp, c0, c1) == (3_088_271_360, 2_147_313_664, 2_147_690_496)
    assert c1 - c0 == 376_832
    first, rows = traffic["first_row"], traffic["unit_rows"]
    assert first + rows == 1 << 31 and c0 < 1 << 31 < c1 <= first + 2 * rows
    # a unit's one-hot: 2^24 rows of 512 bytes, past 2^31 bytes
    assert rows * 128 * -(-5 * config["K"] // 128) == 8_589_934_592
    assert (Gp - first) // rows == 57 and -(-Gp // rows) == 185


def test_the_sound_run_is_correct_and_its_control_fails():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {
        "blocks_length_wrong", "blocks_run_again_differing",
        "random_rows_differing", "self_rows_differing",
        "copies_rows_differing"}
    assert out["attempted"] == 2_048 * len(out["run"]["unit_ends_s"])
    bench, _, config, traffic = tiny()
    got = control.control_readings(bench, CELL, SEED, CPU, config, traffic)
    assert any(v > lim for v, lim in got.values()), got


@pytest.mark.parametrize("fault", ["a dropped strand",
                                   "a block off by one row",
                                   "a column base cut to 32 bits"])
def test_faults_are_caught(monkeypatch, fault):
    _broken(monkeypatch, fault)
    assert not _run()["correct"]


def test_a_traced_run_on_the_cpu_reads_no_onehot_time():
    """The CPU runs no device records: the reader gives None, and the
    line leaves the metric out."""
    out = _run(trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"device_idle_pct.hammings",
                                   "idle_between_blocks_ms.hammings_rows"}


class _Ctx:
    def __init__(self, trace, units):
        self.trace, self.units, self.info, self.card = trace, units, {}, ""


def test_the_onehot_reader_takes_the_records_up_to_the_next_kernel():
    """Two blocks: the records from each `hammings.onehot` span's start to
    the next minmm launch, overlaps counted once; the kernels, the
    collect's copy and what came before the span are left out."""
    read = run.metric_reader(ONEHOT)
    ms = 1_000_000
    host = [("hammings.rows", 0, 40 * ms), ("hammings.onehot", 1 * ms,
                                            2 * ms),
            ("hammings.onehot", 20 * ms, 21 * ms)]
    device = [("Memset (Device)", 0, 1 * ms),              # before the span
              ("elementwise_kernel", 1 * ms, 4 * ms),
              ("elementwise_kernel", 3 * ms, 5 * ms),      # overlaps: 1..5
              ("minmm_kernel<1>", 6 * ms, 15 * ms),
              ("elementwise_kernel", 15 * ms, 16 * ms),    # the collect's
              ("Memcpy DtoH", 16 * ms, 17 * ms),
              ("vectorized_elementwise_kernel", 22 * ms, 24 * ms),
              ("minmm_kernel<1>", 25 * ms, 30 * ms)]
    tr = Trace((0, 40 * ms), device, [], host)
    assert read(_Ctx(tr, 2)) == pytest.approx((4 + 2) / 2)
    # the last block's kernel past the window's end: up to the end
    tr = Trace((0, 25 * ms), device, [], host)
    assert read(_Ctx(tr, 2)) == pytest.approx((4 + 2) / 2)
    assert read(_Ctx(Trace((0, 40 * ms), device, [], host[:1]), 2)) is None
    assert read(_Ctx(Trace((0, 40 * ms), [], [], host), 2)) is None
    assert read(_Ctx(tr, 0)) is None


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_onehot_time(card):
    out = _run(trace=True, seconds=0.5, device=card, seed=2**31 + 9)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(got) == set(METRICS)
    assert got[ONEHOT]["value"] > 0
    assert 0 < got["minmm_roofline"]["value"] <= 105
