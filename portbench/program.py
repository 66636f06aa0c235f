"""The system under test: the port's streaming executor, built from a
configuration's ``pipeline`` options. The only module of the harness that
imports the port; it does so when a pipeline is made."""

from __future__ import annotations

import torch


def pipeline(device: torch.device, cfg: dict, depth: int, power_fn=None):
    """A ``PowerPipeline`` on ``device`` running ``cfg``'s mode; with
    ``power_fn``, that step in the program's own (the control)."""
    from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline
    return PowerPipeline(device, power_fn=power_fn, depth=depth,
                         name="portbench", **cfg["pipeline"])
