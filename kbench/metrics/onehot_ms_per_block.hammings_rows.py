"""Milliseconds a unit the device spent building the own rows' one-hot in
the streamed-rows hammings cells: for each of the program's spans
`hammings.onehot` in the window, the union of the device records that
start at or after the span's start and before the next `minmm_kernel`
record's start (the window's end where none follows), over the units the
window ran. The stream runs in order, and the host has waited for the
device at the previous block's collect, so those records are the block's
validity scan, the one-hot's memset and its K writes.

None where the window holds no `hammings.onehot` span (a program without
its own spans) or no device record after one (a run on the CPU)."""
import bisect

SPAN = "hammings.onehot"
KERNEL = "minmm_kernel"


def read(ctx):
    tr = ctx.trace
    lo, hi = tr.window
    starts = sorted(s for n, s, _ in tr.host_ops
                    if n == SPAN and lo <= s < hi)
    if not ctx.units or not starts:
        return None
    dev = sorted(((max(s, lo), min(e, hi), n) for n, s, e in tr.device
                  if min(e, hi) > max(s, lo)))
    dev_starts = [s for s, _, _ in dev]
    kernels = [s for s, _, n in dev if KERNEL in n]
    total = 0
    for s in starts:
        k = bisect.bisect_left(kernels, s)
        end = kernels[k] if k < len(kernels) else hi
        reach = s       # the union of the records, which come sorted
        for a, b, _ in dev[bisect.bisect_left(dev_starts, s):
                           bisect.bisect_left(dev_starts, end)]:
            total += max(0, b - max(a, reach))
            reach = max(reach, b)
    return total * 1e-6 / ctx.units if total else None
