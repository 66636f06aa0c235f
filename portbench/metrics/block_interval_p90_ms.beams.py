"""90th percentile, in ms, of the executor's intervals between two records
of one beam (``PipelineStats.block_seconds``), both records of blocks sent
in the window, pooled over beams."""

import statistics


def read(ctx):
    xs = [x for s in ctx.streams for x in s.intervals]
    if len(xs) < 10:
        return None
    return statistics.quantiles(xs, n=10)[-1] * 1e3
