"""The traced run: `torch.profiler` over the measured window, reduced to
plain intervals, and the reductions the per-layer metrics read.

Only the device's own records count as device time: kernels, copies and
memsets, as the profiler's CUDA activity gives them. Busy time is the
union of their intervals inside the window, so kernels that overlap are
counted once. Host spans are the harness's `record_function` spans around
calls into the program's layers, and the operators the profiler records on
the host; an idle gap is named by what covered its midpoint on the host.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "kbench.window"
MAX_NAMED_GAPS = 4000


@dataclass
class Trace:
    """Intervals in nanoseconds on the profiler's one clock."""
    window: tuple[int, int]
    device: list[tuple[str, int, int]] = field(default_factory=list)
    spans: list[tuple[str, int, int]] = field(default_factory=list)
    host_ops: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self, items):
        lo, hi = self.window
        for name, s, e in items:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                yield name, s, e

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device's intervals inside the window, sorted."""
        merged: list[list[int]] = []
        for _, s, e in sorted(self._clipped(self.device),
                              key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s(self, name_part: str) -> float:
        """Seconds of the device records whose name holds `name_part`."""
        return sum(e - s for n, s, e in self._clipped(self.device)
                   if name_part in n) * 1e-9

    def top_device_ops(self, n: int = 10) -> list[list]:
        tot: dict[str, int] = defaultdict(int)
        for name, s, e in self._clipped(self.device):
            tot[name[:120]] += e - s
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds of the device, summed by what the host was doing
        at each gap's midpoint (the innermost harness span and host
        operator covering it); the longest MAX_NAMED_GAPS gaps are named,
        the rest summed as one entry."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)
        spans = _Stabber(self.spans)
        ops = _Stabber(self.host_ops)
        tot: dict[str, int] = defaultdict(int)
        for k, (length, start) in enumerate(gaps):
            if k >= MAX_NAMED_GAPS:
                tot["(shorter gaps)"] += length
                continue
            mid = start + length // 2
            name = " > ".join(x for x in (spans.innermost(mid),
                                          ops.innermost(mid)) if x)
            tot[name or "(no host span or operator)"] += length
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class _Stabber:
    """Innermost (shortest) interval covering a point, among intervals
    sorted by start; nesting is shallow, so a bounded look back finds it."""

    LOOK_BACK = 64

    def __init__(self, items):
        self.items = sorted(items, key=lambda t: t[1])
        self.starts = [s for _, s, _ in self.items]

    def innermost(self, t: int) -> str:
        i = bisect.bisect_right(self.starts, t)
        best = None
        for name, s, e in self.items[max(0, i - self.LOOK_BACK):i]:
            if e >= t and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else ""


@contextlib.contextmanager
def wrapped_spans(targets):
    """For each (module path, attribute path, span name), the callable at
    that path runs inside a `record_function` span of that name until the
    block ends. Methods and classmethods are wrapped on their class."""
    import torch
    undo = []
    try:
        for mod_name, path, span in targets:
            owner = importlib.import_module(mod_name)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            raw = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            fn = raw.__func__ if isinstance(raw, classmethod) else raw

            def wrapper(*a, _fn=fn, _span=span, **kw):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **kw)
            wrapper = functools.wraps(fn)(wrapper)
            setattr(owner, attr, classmethod(wrapper)
                    if isinstance(raw, classmethod) else wrapper)
            undo.append((owner, attr, raw))
        yield
    finally:
        for owner, attr, raw in reversed(undo):
            setattr(owner, attr, raw)


def profiled(run, span_targets=()):
    """Runs `run()` under torch.profiler (host and CUDA activity) inside a
    WINDOW_SPAN span, with the harness spans of `span_targets`; returns
    (run's result, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with wrapped_spans(span_targets):
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                out = run()
            if cuda:
                torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    names = {t[2] for t in span_targets} | {WINDOW_SPAN}
    window = None
    dev, spans, ops = [], [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        item = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() == cuda_type:
            # the profiler mirrors host spans onto the device's timeline;
            # they cover gaps and are no device work
            if item[0] not in names:
                dev.append(item)
        elif item[0] == WINDOW_SPAN:
            window = item[1:]
        elif item[0] in names:
            spans.append(item)
        else:
            ops.append(item)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return out, Trace(window, dev, spans, ops)


def idle_pct(trace: Trace) -> float | None:
    """Per cent of the window in which the device ran nothing."""
    w = trace.window_s
    return 100.0 * (1.0 - trace.busy_s() / w) if w > 0 else None
