"""Milliseconds the device was busy (the union of its kernels, copies and
memsets) in the kalign cell's window, per batch of reads the window
aligned."""


def read(ctx):
    n = ctx.units * ctx.info["batches_per_unit"]
    return ctx.trace.busy_s() * 1e3 / n if n else None
