"""The program's spans in the benchmark: a traced CPU run of each cell
reports the cell's program-span metrics, a program without spans reports
none of them, and the trace's charge rule gives a program span the idle
gaps under the operations inside it, while the span's range on the
device's timeline stays out of the device's work."""

import contextlib

import pytest
import torch
from _tiny import TINY

from portbench import run, spans
from portbench import trace as T
from paf_baseband2power_tpu_torch.runtime import pipeline as RP

NEW = {"power.beams": ["host_copy_ms.beams", "slot_wait_ms.beams",
                       "record_wait_ms.beams", "dispatch_ms.beams"],
       "pfb1024.resident": ["dispatch_ms.resident"],
       "power.resident": ["dispatch_ms.resident"]}
ABOVE_ZERO = {"host_copy_ms.beams", "dispatch_ms.beams",
              "dispatch_ms.resident"}


def _traced(cell):
    result, _ = run.run_cell(run.load_manifest(), cell, 2**31 + 17, 0.3,
                             True, torch.device("cpu"), cfg_override=TINY)
    assert result["correct"], result["check"]
    return result["metrics"]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_run_reports_the_program_spans(cell):
    got = _traced(cell)
    for name in NEW[cell]:
        assert name in got and got[name]["unit"] == "ms"
        # on the CPU nothing waits for an event: the waits read 0
        assert got[name]["value"] > 0 if name in ABOVE_ZERO else \
            got[name]["value"] >= 0


@pytest.mark.parametrize("cell", sorted(NEW))
def test_program_without_spans_reports_none(monkeypatch, cell):
    """As at a commit whose executor records no span: the readers find
    nothing, raise nothing, and the line leaves their metrics out."""
    monkeypatch.setattr(RP, "span", lambda name: contextlib.nullcontext())
    got = _traced(cell)
    assert not set(NEW[cell]) & set(got)


def test_untraced_run_has_no_program_spans():
    ctx = run.Context("power.beams", {}, {}, [], None, 0.0, None)
    assert spans.totals(ctx) is None and spans.program_ms(ctx, []) is None


class _Event:
    def __init__(self, name, a, b, cuda=False, annotation=False):
        self._n, self._a, self._b = name, a, b
        self._cuda, self._ann = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._ann


class _Prof:
    """A stopped profiler's surface as ``trace.reduce`` reads it."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()

    def stop(self):
        pass


def test_gap_under_an_op_inside_a_program_span_goes_to_the_span():
    """The card idles [200, 300) ns, under an ``aten::copy_`` that
    ``pafb2p.stage.h2d`` encloses: both overlap the gap alike, the span
    started first and is charged. The span's range on the device's
    timeline (a user annotation) is no device work."""
    events = [
        _Event("pafb2p.stage.h2d", 100, 600),
        _Event("aten::copy_", 200, 300),
        _Event("Memcpy HtoD (Pinned -> Device)", 0, 200, cuda=True),
        _Event("power_kernel", 300, 1000, cuda=True),
        _Event("pafb2p.stage.h2d", 100, 600, cuda=True, annotation=True),
        _Event("pafb2p.step", 250, 950, cuda=True, annotation=True),
    ]
    tr = T.reduce(_Prof(events), 0, 1000)
    assert tr.idle_gaps == {"pafb2p.stage.h2d": pytest.approx(100e-9)}
    assert tr.busy_s == pytest.approx(900e-9)
    assert set(tr.device_s) == {"Memcpy HtoD (Pinned -> Device)",
                                "power_kernel"}
