"""The program's own spans (``pafb2p.*``, ``runtime/trace.py`` of the port)
in a traced run's window, for the readers of ``program_span`` metrics.

The reduced trace that ``run.run_cell`` hands the readers keeps no host
event, so these readers read the stopped profiler's host events again: the
profiler is the ``torch.profiler.profile`` that a caller of the reader
holds (``run_cell``'s own), found by walking up the stack. Each span counts
with its part inside the window, summed over threads.
"""

from __future__ import annotations

import sys

import torch

from .metrics import window_blocks

PREFIX = "pafb2p."


def _caller_profiler():
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        frame = frame.f_back
    return None


def totals(ctx) -> dict | None:
    """Program span name -> ``[count, seconds in the window]``, or None
    when the run was not traced."""
    prof = _caller_profiler() if ctx.trace is not None else None
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None:
        return None
    t0, t1 = ctx.clock.t0_ns, ctx.clock.t1_ns
    out: dict = {}
    for e in res.events():
        name = e.name()
        if (not name.startswith(PREFIX)
                or e.device_type() != torch.autograd.DeviceType.CPU):
            continue
        a = max(e.start_ns(), t0)
        b = min(e.start_ns() + e.duration_ns(), t1)
        if b > a:
            n = out.setdefault(name, [0, 0.0])
            n[0] += 1
            n[1] += (b - a) / 1e9
    return out


def program_ms(ctx, names) -> float | None:
    """ms per window block of the program's spans ``names``, summed over
    them and over threads. None when the trace holds no program span at
    all (a program without spans, or no trace); 0 when the program
    recorded spans but none of these (a wait that never came)."""
    spans, n = totals(ctx), window_blocks(ctx)
    if not spans or not n:
        return None
    return sum(spans[k][1] for k in names if k in spans) / n * 1e3
