"""Host ms per window block spent waiting for a block's record, its
kernel and D2H, to reach pinned memory (``pafb2p.drain.wait``): a beam
held by the card. 0 when no beam waited."""

from ..spans import program_ms


def read(ctx):
    return program_ms(ctx, ["pafb2p.drain.wait"])
