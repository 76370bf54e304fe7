"""Milliseconds a sweep in which the device ran nothing while the host was
between two of the exhaustive hammings cell's sweeps: inside the program's
span `hammings.fold` (the maxima made distances on the card, inside
`hammings.collect`) or `hammings.upload` (the next sweep's genome padded
and copied to the card).

The window's idle intervals (the gaps between the device's busy
intervals) intersected with the union of those spans, clipped to the
window, over the units the window ran. None where the window holds no
`hammings.sweep` span: a program without its own spans."""

SPANS = ("hammings.fold", "hammings.upload")
SWEEP = "hammings.sweep"


def _union(intervals):
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_in_spans_ms(ctx, names) -> float | None:
    """Milliseconds a unit of device idle inside the spans `names`."""
    tr = ctx.trace
    lo, hi = tr.window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in tr.host_ops]
    ops = [op for op in ops if op[2] > op[1]]
    if not ctx.units or not any(n == SWEEP for n, _, _ in ops):
        return None
    edges = [lo] + [x for iv in tr.busy_intervals() for x in iv] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = _union((s, e) for n, s, e in ops if n in names)
    total, j = 0, 0
    for s, e in idle:
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            total += min(e, spans[k][1]) - max(s, spans[k][0])
            k += 1
    return total * 1e-6 / ctx.units


def read(ctx):
    return idle_in_spans_ms(ctx, SPANS)
