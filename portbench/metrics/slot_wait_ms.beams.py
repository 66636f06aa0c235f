"""Host ms per window block spent waiting for a pinned slot whose last
H2D had not finished (``pafb2p.stage.wait``): a beam held by the copy
engine. 0 when no beam waited."""

from ..spans import program_ms


def read(ctx):
    return program_ms(ctx, ["pafb2p.stage.wait"])
