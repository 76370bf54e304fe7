"""Run logging and phase timers, the port's own copy of
kit4b_tpu/utils/runtime.py (without its XLA compile cache and JSONL
records). The port logs under the logger "kit4b_tpu_torch".

The reference's observability is CDiagnostics leveled logging + CStopWatch
(libkit4b/Diagnostics.cpp, SURVEY.md §5.5); here: stdlib logging and phase
timers.
"""
from __future__ import annotations

import logging
import time
from contextlib import contextmanager

log = logging.getLogger("kit4b_tpu_torch")


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
    (CStopWatch parity, libkit4b/StopWatch.h)."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self._t0 = time.time()

    @contextmanager
    def phase(self, name: str):
        t = time.time()
        log.info("phase %s: start", name)
        try:
            yield
        finally:
            dt = time.time() - t
            self.phases[name] = self.phases.get(name, 0.0) + dt
            log.info("phase %s: %.2fs", name, dt)

    def total(self) -> float:
        return time.time() - self._t0
