"""Metric readers, one file per metric, named as ``BENCHMARK.json`` names
the metric (``<name>.py``). Each has ``read(ctx) -> float | None``; ``ctx``
is ``run.Context``. A reader that finds nothing to read returns None, and
the run leaves that metric out of its line. Shared arithmetic is here.
"""

from __future__ import annotations

from ..stream import block_stream_seconds


def realtime(ctx) -> float | None:
    """Stream seconds of every block sent in the window whose record came,
    over the seconds from the window's opening to its last record."""
    n = sum(s.window_records() for s in ctx.streams)
    if not n or ctx.clock.seconds <= 0:
        return None
    return n * block_stream_seconds(ctx.cfg) / ctx.clock.seconds


def window_blocks(ctx) -> int:
    return sum(s.window_records() for s in ctx.streams)


def idle_share(ctx) -> float | None:
    """Percent of the traced window in which no operation ran on the
    card."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
