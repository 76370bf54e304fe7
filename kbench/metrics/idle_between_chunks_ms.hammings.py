"""Milliseconds a sweep in which the device ran nothing while the host was
collecting a row chunk of the exhaustive hammings cell: inside the
program's span `hammings.collect` (the strands' maximum, the blocking copy
of the chunk's maxima to the host and their copy into the sweep's array).
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
