"""A run's check catches the faults its cell can have. Each test drives a
whole run on the CPU at a tiny size, with the look for a card skipped and
the program's timed path broken underneath: half of the work left out, or
an answer altered where it is produced. The cells run on one card and keep
no state from step to step, so the exchange between cards and a step that
returns its state unchanged have no place here. The sound run comes out
correct."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from kbench import run
from conftest import CELLS, all_cells, tiny

CPU = torch.device("cpu")


def _run(name, trace=False):
    bench, cell, config, traffic = tiny(name)
    return run.run_cell(bench, cell, config, traffic, 2**31 + 99, 0.2,
                        trace, CPU, time.perf_counter())


def _half_left_out(out):
    out = out.copy()
    out[len(out) // 2:] = 0xFFFF
    return out


def _altered(out):
    out = out.copy()
    sel = np.zeros(len(out), bool)
    sel[::7] = True
    out[sel & (out < 20)] += 1
    return out


FAULTS = {"half of the work left out": _half_left_out,
          "an answer altered": _altered}


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name,fn", [(CELLS[0], "hammings_exhaustive"),
                                     (CELLS[2], "hammings_restricted")])
def test_hammings_faults_are_caught(monkeypatch, name, fn, fault):
    from kit4b_tpu_torch.kmer import hammings
    real = getattr(hammings, fn)
    monkeypatch.setattr(hammings, fn,
                        lambda *a, **kw: FAULTS[fault](real(*a, **kw)))
    out = _run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_kalign_faults_are_caught(monkeypatch, fault):
    from kit4b_tpu_torch.align import kalign
    real = kalign.KAligner._collect_compact

    def broken(self, devout, reads, n=None):
        raw = real(self, devout, reads, n)
        B = len(raw["nar"])
        if fault == "half of the work left out":
            raw["nar"][B // 2:] = 1            # reported as no hit
        else:
            acc = np.nonzero(raw["nar"] == 0)[0][::5]
            raw["pos"][acc] += 1
        return raw
    monkeypatch.setattr(kalign.KAligner, "_collect_compact", broken)
    out = _run(CELLS[1])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_the_cells_per_layer_metrics(name):
    out = _run(name, trace=True)
    assert out["correct"]
    names = {m["name"] for m in run.cell_metrics(all_cells(),
                                                 {"name": name}, True)}
    # the CPU runs no kernel: idle shares read 100, rooflines nothing
    assert set(out["metrics"]) <= names
    assert all(v["value"] == 100.0 for k, v in out["metrics"].items()
               if k.startswith("device_idle_pct"))
    assert "minmm_roofline" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["idle_gaps"]) >= 1
