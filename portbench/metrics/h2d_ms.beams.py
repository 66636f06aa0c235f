"""Device ms of host-to-device copies per block whose record came in the
traced window."""

from . import window_blocks


def read(ctx):
    n = window_blocks(ctx)
    if ctx.trace is None or not n or ctx.trace.h2d_s() <= 0:
        return None
    return ctx.trace.h2d_s() / n * 1e3
