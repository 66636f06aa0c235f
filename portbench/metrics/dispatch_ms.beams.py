"""Host ms per window block in the program's enqueue of a block's device
work: the H2D (``pafb2p.stage.h2d``), the step's launches
(``pafb2p.step``) and the D2H (``pafb2p.fetch``)."""

from ..spans import program_ms


def read(ctx):
    return program_ms(ctx, ["pafb2p.stage.h2d", "pafb2p.step",
                            "pafb2p.fetch"])
