"""Host ms per window block in the program's copy of a block into its
pinned slot (``pafb2p.stage.copy``, ``_Staging.put``'s ``np.copyto``):
host memory's share of a beam's block."""

from ..spans import program_ms


def read(ctx):
    return program_ms(ctx, ["pafb2p.stage.copy"])
