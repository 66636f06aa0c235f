"""Percent of the roofline: the least time of a block's work
(``peaks.block_bound``: bytes over the HBM rate or fp32 operations over
the fp32 rate) over the device time of every kernel in the traced window,
whatever its name, per block whose record came."""

from ..peaks import block_bound
from . import window_blocks


def read(ctx):
    n = window_blocks(ctx)
    if ctx.trace is None or not n or ctx.trace.kernel_s() <= 0:
        return None
    least_ms, _ = block_bound(ctx.cfg)
    return 100.0 * least_ms / (ctx.trace.kernel_s() / n * 1e3)
