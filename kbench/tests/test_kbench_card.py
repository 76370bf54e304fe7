"""On the card only (marker `cuda`; each test skips where there is no
card): every cell runs through its whole timed path at the tiny size and
comes out correct, and each control fails at the cell's own size on one
seed. Run on the card with `python -m pytest kbench/tests -m cuda`."""
from __future__ import annotations

import time

import pytest

from kbench import control, run
from conftest import CELLS, all_cells, tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_card(card, name):
    bench, cell, config, traffic = tiny(name)
    out = run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.5, True,
                       card, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    got = control.control_readings(all_cells(), name, 2**31 + 6, card)
    assert any(v > lim for v, lim in got.values()), got
