"""Host ms per window block in ``PowerPipeline.power`` (``pafb2p.step``):
the step's host dispatch, the PFB carry's included; the harness does the
D2H itself."""

from ..spans import program_ms


def read(ctx):
    return program_ms(ctx, ["pafb2p.step"])
