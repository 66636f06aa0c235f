"""The executor's spans (``runtime/trace.py``) on the CPU: each block's
steps recorded in the loop's order, flat, on the thread that runs the
pipeline, under a profiler that traces every host thread; nothing but a
flag read while no profiler records; and the two waits, spanned and counted
in ``PipelineStats``, exactly when an event has not completed."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from paf_baseband2power_tpu_torch.runtime import pipeline as RP
from paf_baseband2power_tpu_torch.runtime import trace as RT

NDF, NCHK = 16, 2
STAGE = ["source", "stage.copy", "stage.h2d", "step", "fetch"]


def _profiler():
    """Started as the benchmark's traced run starts it: every host
    thread."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=cfg)
    prof.start()
    return prof


def _spans(prof) -> list:
    """Stop ``prof``; ``(thread, start, end, name)`` of each program span,
    in time order."""
    prof.stop()
    return sorted((e.start_thread_id(), e.start_ns(),
                   e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(RT.PREFIX))


def _loop_order(nblocks: int, depth: int) -> list:
    """The spans of ``run()``'s loop on the CPU, block after block."""
    want, inflight = [], 0
    for _ in range(nblocks):
        want += STAGE
        inflight += 1
        if inflight > depth:
            want.append("sink")
            inflight -= 1
    return want + ["source"] + ["sink"] * inflight


def _run(nblocks=3, depth=2) -> RP.PipelineStats:
    return RP.PowerPipeline("cpu", depth=depth).run(
        RP.SyntheticSource(nblocks, ndf=NDF, nchk=NCHK, seed=3),
        RP.MemorySink())


@pytest.mark.parametrize("depth", [1, 2])
def test_spans_tile_each_block_on_the_pipelines_thread(depth):
    got = {}
    prof = _profiler()
    try:
        t = threading.Thread(target=lambda: got.update(stats=_run(3, depth)))
        t.start()
        t.join(60)
    finally:
        spans = _spans(prof)
    assert not t.is_alive() and got["stats"].nblocks == 3
    assert len({tid for tid, *_ in spans}) == 1
    assert [n[len(RT.PREFIX):] for *_, n in spans] == _loop_order(3, depth)
    # flat: no program span opens inside another
    for (_, _, end, _), (_, start, _, _) in zip(spans, spans[1:]):
        assert start >= end


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running a span is the one shared null context:
    ``record_function`` is never reached."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert RT.span("step") is RT._OFF
    assert _run().nblocks == 3


def test_span_reads_the_flag_through_its_module(monkeypatch):
    """The flag is read on every call, not imported by value."""
    names = []

    def record(name):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", record)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    assert _run(1, 1).nblocks == 1
    assert [n[len(RT.PREFIX):] for n in names] == _loop_order(1, 1)


class _Event:
    """A CUDA event stand-in: ``query()`` says whether its work is done."""

    def __init__(self, done: bool):
        self.done, self.synced = done, 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.synced += 1


@pytest.mark.parametrize("done", [False, True])
@pytest.mark.parametrize("which", ["slot", "record"])
def test_waits_spanned_and_counted(monkeypatch, which, done):
    """A slot whose H2D event has not completed, or a record whose D2H
    event has not, is waited for in ``stage.wait`` / ``drain.wait`` and
    counted; a completed event is neither waited for nor counted."""
    events = []
    if which == "slot":
        put = RP._Staging.put

        def staged(self, block):
            events.append(_Event(done))
            self.copied[self._next] = events[-1]
            return put(self, block)

        monkeypatch.setattr(RP._Staging, "put", staged)
    else:
        def fetched(self, out, k):
            events.append(_Event(done))
            return out, events[-1]

        monkeypatch.setattr(RP._Staging, "fetch", fetched)
    prof = _profiler()
    try:
        stats = _run(3, 2)
    finally:
        spans = _spans(prof)
    waits = 0 if done else 3
    counted = stats.slot_waits if which == "slot" else stats.record_waits
    other = stats.record_waits if which == "slot" else stats.slot_waits
    assert counted == waits and other == 0
    assert [e.synced for e in events] == [int(not done)] * 3
    span = RT.PREFIX + ("stage.wait" if which == "slot" else "drain.wait")
    assert [n for *_, n in spans].count(span) == waits


def test_slot_wait_comes_before_the_slots_copy():
    """``_Staging.put`` waits for the slot's last H2D, then copies into
    it."""
    stats = RP.PipelineStats()
    staging = RP._Staging((4, 8), torch.device("cpu"), 1, stats)
    staging.copied[0] = _Event(False)
    prof = _profiler()
    try:
        staging.put(np.ones((4, 8), np.int16))
    finally:
        spans = _spans(prof)
    assert [n[len(RT.PREFIX):] for *_, n in spans] == [
        "stage.wait", "stage.copy", "stage.h2d"]
    assert stats.slot_waits == 1 and staging.copied[0].synced == 1
    assert int(staging.host[0].sum()) == 32


def test_wait_for_an_h2d_from_the_source_is_a_slot_wait():
    """Before the source's next block, an unfinished H2D that read the
    last block in place is waited for in ``stage.wait`` and counted as a
    slot wait; a finished one is neither, and each is waited for once."""
    stats = RP.PipelineStats()
    staging = RP._Staging((4, 8), torch.device("cpu"), 1, stats)
    pending, done = _Event(False), _Event(True)
    prof = _profiler()
    try:
        for event in (pending, done, None):
            staging.direct = event
            staging.wait_direct()
    finally:
        spans = _spans(prof)
    assert [n[len(RT.PREFIX):] for *_, n in spans] == ["stage.wait"]
    assert stats.slot_waits == 1 and (pending.synced, done.synced) == (1, 0)
    assert staging.direct is None
