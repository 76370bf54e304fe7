"""The readers of the idle time inside the program's own spans
(`idle_between_sweeps_ms.hammings`, `idle_between_chunks_ms.hammings`):
the arithmetic on traces built by hand, and a traced run of the node cell
on the CPU, whose program spans reach the harness's trace."""
from __future__ import annotations

import time

import pytest
import torch

from kbench import run
from kbench.trace import Trace
from conftest import CELLS, tiny

SWEEPS = "idle_between_sweeps_ms.hammings"
CHUNKS = "idle_between_chunks_ms.hammings"


def _read(metric, trace, units=1):
    return run.metric_reader(metric)(run.Context(trace, units, {}, "cpu"))


def _trace(host_ops, device=(("k", 100, 400), ("k", 600, 900))):
    """A window of 1,000 ns, the device busy in [100, 400) and [600, 900),
    so idle in [0, 100), [400, 600) and [900, 1000)."""
    return Trace((0, 1000), list(device), [], list(host_ops))


def test_overlapping_spans_count_once():
    ops = [("hammings.sweep", 0, 1000), ("hammings.fold", 350, 500),
           ("hammings.upload", 450, 650), ("aten::copy_", 380, 420)]
    # the union [350, 650) meets the idle [400, 600): 200 ns, over 2 units
    assert _read(SWEEPS, _trace(ops), units=2) == pytest.approx(100e-6)
    assert _read(CHUNKS, _trace(ops)) == 0


def test_spans_are_clipped_to_the_window():
    ops = [("hammings.sweep", -500, 1500), ("hammings.upload", -50, 50),
           ("hammings.collect", 950, 1200), ("hammings.collect", 200, 300)]
    assert _read(SWEEPS, _trace(ops)) == pytest.approx(50e-6)
    # [950, 1000) is idle; [200, 300) lies inside busy time
    assert _read(CHUNKS, _trace(ops)) == pytest.approx(50e-6)


def test_idle_gaps_meet_several_spans():
    ops = [("hammings.sweep", 0, 1000)] + [
        ("hammings.collect", s, s + 20) for s in (0, 40, 90, 410, 980)]
    # 20 + 20 + 10 (to 100) + 20 + 20
    assert _read(CHUNKS, _trace(ops)) == pytest.approx(90e-6)
    assert _read(CHUNKS, _trace(ops, device=())) == pytest.approx(100e-6)


@pytest.mark.parametrize("metric", [SWEEPS, CHUNKS])
def test_none_without_a_sweep_span(metric):
    """The parent's trace: the harness's spans, no program span."""
    ops = [("hammings.fold", 400, 600), ("hammings.collect", 400, 600),
           ("aten::copy_", 0, 1000)]
    assert _read(metric, _trace(ops)) is None
    outside = ops + [("hammings.sweep", 1000, 2000)]
    assert _read(metric, _trace(outside)) is None
    assert _read(metric, _trace(ops + [("hammings.sweep", 0, 10)])) \
        is not None


def test_a_traced_run_of_the_node_cell_reads_both():
    """On the CPU the device runs nothing, so each reads the whole of its
    spans: both above 0, and the program's span names never name a
    device record."""
    bench, cell, config, traffic = tiny(CELLS[0])
    out = run.run_cell(bench, cell, config, traffic, 2**31 + 7, 0.2, True,
                       torch.device("cpu"), time.perf_counter())
    assert out["correct"]
    assert out["metrics"][SWEEPS]["value"] > 0
    assert out["metrics"][CHUNKS]["value"] > 0
    assert not any(n.startswith("hammings.sweep")
                   for n, _ in out["breakdown"]["device_ops"])
