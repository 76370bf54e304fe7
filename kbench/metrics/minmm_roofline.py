"""The max-match kernel's share of its roofline in the exhaustive hammings
cells: the least time the card could take for the products the node's work
needs (`kbench.roofline`, from the genome's shapes: the one-hot product at
the card's 2:4-sparse int8 rate), over the device time of the kernel's
launches in the window."""
from kbench.roofline import minmm_bound_s

KERNEL = "minmm_kernel"


def read(ctx):
    t = ctx.trace.device_s(KERNEL)
    shape = ctx.info.get("minmm")
    if not t or not shape:
        return None
    bound = ctx.units * shape["strands"] * minmm_bound_s(
        shape["rows"], shape["cols"], shape["K"], ctx.card)
    return 100.0 * bound / t
