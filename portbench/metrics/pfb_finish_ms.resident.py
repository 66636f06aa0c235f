"""Device ms per window block of the operations launched inside the PFB's
finish (the program's span ``pafb2p.pfb.finish``, ``ops/cuda_pfb.py``):
the float64 partials read and the float32 record written.

Each launch on the host (a CUDA runtime or driver call, named ``cu...``,
inside the span's time) is linked to the operation it put on the card by
the profiler's correlation id, so the reading follows the span whatever
the finish's kernels are named. The resident driver drives one host thread, so a launch
inside the span's time is the span's. None where the trace holds no such
span (the plain route on the CPU, a program without it) or no launch in
one."""

import bisect

import torch

from ..spans import PREFIX, _caller_profiler
from . import window_blocks

SPAN = PREFIX + "pfb.finish"
API_PREFIX = "cu"       # cudaLaunchKernel, cuLaunchKernel, ...


def read(ctx):
    n = window_blocks(ctx)
    prof = _caller_profiler() if ctx.trace is not None else None
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None or not n:
        return None
    events = res.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name() == SPAN
                   and e.device_type() != torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    launches, ops = [], {}
    for e in events:
        if e.correlation_id() <= 0 or e.is_user_annotation():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops[e.correlation_id()] = (e.start_ns(),
                                       e.start_ns() + e.duration_ns())
        elif e.name().startswith(API_PREFIX):
            launches.append((e.start_ns(), e.correlation_id()))
    starts = [a for a, _ in spans]
    t0, t1 = ctx.clock.t0_ns, ctx.clock.t1_ns
    total, found = 0, False
    for at, corr in launches:
        i = bisect.bisect_right(starts, at) - 1     # the last span begun
        if i < 0 or at > spans[i][1] or corr not in ops:
            continue
        found = True
        a, b = ops[corr]
        total += max(0, min(b, t1) - max(a, t0))
    return total / 1e6 / n if found else None

