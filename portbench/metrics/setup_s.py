"""Seconds from the process's start to the window's opening: imports, the
kernels' build or load, the pool, the executor and the warm prefix."""


def read(ctx):
    return ctx.setup_s
