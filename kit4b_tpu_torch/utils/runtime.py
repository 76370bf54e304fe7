"""Run logging and phase timers, the port's own copy of
kit4b_tpu/utils/runtime.py (without its XLA compile cache and JSONL
records), and the port's trace spans. The port logs under the logger
"kit4b_tpu_torch".

The reference's observability is CDiagnostics leveled logging + CStopWatch
(libkit4b/Diagnostics.cpp, SURVEY.md §5.5); here: stdlib logging, phase
timers and `span`.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager, nullcontext

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None

log = logging.getLogger("kit4b_tpu_torch")


def span(name: str):
    """A trace span `name` around a block of host work: a plain host
    operator (`cpu_op`) in a `torch.profiler` trace, on the clock of the
    device's records, so an idle gap of the device can be named by what the
    host was doing. With no profiler running it costs well under a
    microsecond; it records nothing else.

    Not `torch.profiler.record_function`: its spans are user annotations,
    which the profiler mirrors onto the device's timeline around each
    launch inside them, where a trace would count them as device work.
    Without `_RecordFunctionFast` (an older torch) the span is a null
    context."""
    if _RecordFunctionFast is None:
        return nullcontext()
    return _RecordFunctionFast(name)


def setup_logging(level: str = "info", logfile: str | None = None) -> None:
    """Dual screen+file leveled logging (CDiagnostics parity,
    libkit4b/Diagnostics.h:9-46)."""
    lvl = getattr(logging, level.upper(), logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if logfile:
        handlers.append(logging.FileHandler(logfile))
    logging.basicConfig(
        level=lvl,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        handlers=handlers, force=True)


class PhaseTimer:
    """Named phase wall-clock accounting, reported in run summaries
    (CStopWatch parity, libkit4b/StopWatch.h); each phase is also a
    `span` of its name."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        log.info("phase %s: start", name)
        try:
            with span(name):
                yield
        finally:
            dt = time.time() - t
            self.phases[name] = self.phases.get(name, 0.0) + dt
            log.info("phase %s: %.2fs", name, dt)

    def total(self) -> float:
        return time.time() - self._t0
