"""Milliseconds a unit in which the device ran nothing while the host was
between two own-row blocks of the streamed-rows hammings cell: inside the
program's span `hammings.collect` (the strands' maximum, the distances
made on the card, one copy of 2 bytes a row into the node's pinned
buffer, the sync and the copy-out) or `hammings.fold` (inside it: the
maxima made distances on the card). The arithmetic is
`idle_between_sweeps_ms.hammings`'s, with `hammings.rows` (one own-row
block) as the span the window must hold; None where it holds none: a
program without its own spans."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "kbench.metrics.idle_between_blocks_ms_hammings_rows_arith",
    Path(__file__).with_name("idle_between_sweeps_ms.hammings.py"))
_arith = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_arith)
_arith.SWEEP = "hammings.rows"    # this private copy's required span

SPANS = ("hammings.collect", "hammings.fold")


def read(ctx):
    return _arith.idle_in_spans_ms(ctx, SPANS)
