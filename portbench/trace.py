"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result line need.

Device operations are the trace's CUDA events (kernels, memcpys,
memsets) on any stream, not the ranges the profiler draws on the device's
timeline for host spans; times are unix nanoseconds, the clock the
profiler stamps events with. ``busy`` is the union of the device
operations' intervals inside the window. An idle gap is charged to the
harness span (``portbench.*``) that overlaps it most, else to the host
operation that does, else to ``host_code_without_a_span``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

SPAN_PREFIX = "portbench."
NO_SPAN = "host_code_without_a_span"
_TOP = 10


def span(name: str, on: bool):
    """A harness span in traced runs, nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


def start():
    """Start tracing the host (every thread) and the card."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=acts, experimental_config=cfg)
    prof.start()
    return prof


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict          # device operation name -> seconds in the window
    idle_gaps: dict         # what the host did -> idle seconds

    def device_seconds(self, pred) -> float:
        return sum(v for k, v in self.device_s.items() if pred(k))

    def kernel_s(self) -> float:
        return self.device_seconds(lambda k: not is_copy(k))

    def h2d_s(self) -> float:
        return self.device_seconds(lambda k: k.startswith("Memcpy HtoD"))

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:64], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]
        return {"device_ops": top(self.device_s),
                "idle_gaps": top(self.idle_gaps)}


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _clip(a: int, b: int, t0: int, t1: int) -> tuple[int, int]:
    return max(a, t0), min(b, t1)


def reduce(prof, t0_ns: int, t1_ns: int) -> Trace:
    """Stop ``prof`` and reduce its events inside ``[t0_ns, t1_ns]``."""
    prof.stop()
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = _clip(e.start_ns(), e.start_ns() + e.duration_ns(), t0_ns,
                     t1_ns)
        if b <= a:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a harness span's range on the device's timeline is no work
            if not (e.is_user_annotation()
                    or e.name().startswith(SPAN_PREFIX)):
                dev.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
    device_s = collections.Counter()
    for a, b, name in dev:
        device_s[name] += (b - a) / 1e9
    # the union of device intervals, and the gaps between them
    dev.sort()
    busy, gaps, end = 0, [], t0_ns
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < t1_ns:
        gaps.append((end, t1_ns))
    return Trace(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
                 device_s=dict(device_s), idle_gaps=_charge(gaps, host))


def _charge(gaps: list, host: list) -> dict:
    """Charge each gap to the host event that overlaps it most, harness
    spans first. One sweep: gaps are disjoint and in order, and the events
    open at any moment are few (threads times nesting)."""
    spans = _Sweep(h for h in host if h[2].startswith(SPAN_PREFIX))
    ops = _Sweep(h for h in host if not h[2].startswith(SPAN_PREFIX))
    out = collections.Counter()
    for lo, hi in gaps:
        name = spans.most_overlap(lo, hi) or ops.most_overlap(lo, hi)
        out[name or NO_SPAN] += (hi - lo) / 1e9
    return dict(out)


class _Sweep:
    """Events ``(start, end, name)`` swept by intervals in time order."""

    def __init__(self, events):
        self.events = sorted(events)
        self.next = 0
        self.open: list = []

    def most_overlap(self, lo: int, hi: int) -> str | None:
        ev = self.events
        while self.next < len(ev) and ev[self.next][0] < hi:
            self.open.append(ev[self.next])
            self.next += 1
        self.open = [e for e in self.open if e[1] > lo]
        best, name = 0, None
        for a, b, n in self.open:
            ov = min(b, hi) - max(a, lo)
            if ov > best:
                best, name = ov, n
        return name
