"""Milliseconds a sweep in which the device ran nothing while the host was
collecting a block of own rows of the exhaustive hammings cell: inside the
program's span `hammings.collect` (the strands' maximum, the distances
made on the card, one copy of 2 bytes a row into the node's pinned
buffer, the sync and the copy-out).
The arithmetic is `idle_between_sweeps_ms.hammings`'s; None where the
window holds no `hammings.sweep` span."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "kbench.metrics.idle_between_sweeps_ms_hammings",
    Path(__file__).with_name("idle_between_sweeps_ms.hammings.py"))
_sweeps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sweeps)

SPANS = ("hammings.collect",)


def read(ctx):
    return _sweeps.idle_in_spans_ms(ctx, SPANS)
