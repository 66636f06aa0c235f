"""``correct`` comes out false when the timed path is broken underneath,
and for the control; the harness's look for a card is skipped (CPU,
tiny block)."""

import numpy as np
import pytest
import torch
from _tiny import TINY

from portbench import check, run
from paf_baseband2power_tpu_torch.ops import pfb as PF
from paf_baseband2power_tpu_torch.ops import power as P


def _run(cell, step_for=None):
    manifest = run.load_manifest()
    result, _ = run.run_cell(manifest, cell, 4242, 0.3, False,
                             torch.device("cpu"), step_for=step_for,
                             cfg_override=TINY)
    return result


def _pfb(cfg):
    p = cfg["pipeline"]
    return p["pfb_nfft"], p["pfb_ntap"]


def half_power(cfg):
    """Half of the block left out, the rest counted twice."""
    return lambda x: 2 * P.baseband2power_2d(x[:x.shape[0] // 2])


def half_pfb(cfg):
    nfft, ntap = _pfb(cfg)

    def step(x, carry):
        half = x[:x.shape[0] // 2]
        out = PF.pfb_power(half, nfft, ntap, history=carry)
        return 2 * out, PF.pfb_history(x, nfft, ntap)
    return step


def stale_carry(cfg):
    """The step returns the carry it was given: the state never moves."""
    nfft, ntap = _pfb(cfg)

    def step(x, carry):
        return PF.pfb_power(x, nfft, ntap, history=carry), carry
    return step


def altered_power(cfg):
    """One value of the third record one float32 step off."""
    n = [0]

    def step(x):
        out = P.baseband2power_2d(x)
        n[0] += 1
        if n[0] == 3:
            out[5] = float(np.nextafter(np.float32(out[5].item()),
                                        np.float32(np.inf)))
        return out
    return step


def altered_pfb(cfg):
    """The third record's peak raised by 1e-4 of itself."""
    nfft, ntap = _pfb(cfg)
    n = [0]

    def step(x, carry):
        out, h = PF.pfb_power(x, nfft, ntap, history=carry,
                              return_history=True)
        n[0] += 1
        if n[0] == 3:
            out[out.argmax()] *= 1 + 1e-4
        return out, h
    return step


def control(cfg):
    return check.reference_module(cfg).control(cfg)


@pytest.mark.parametrize("cell, fault", [
    ("power.beams", half_power), ("power.resident", half_power),
    ("pfb1024.resident", half_pfb), ("pfb1024.resident", stale_carry),
    ("power.beams", altered_power), ("power.resident", altered_power),
    ("pfb1024.resident", altered_pfb),
    ("power.beams", control), ("power.resident", control),
    ("pfb1024.resident", control),
])
def test_fault_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert result["correct"] is False
    assert result["failed"] > 0


def test_missing_record_is_not_correct(monkeypatch):
    """A beam's sink that loses one record."""
    from portbench.drivers import beams
    orig = beams._Sink.write
    seen = [0]

    def lossy(self, row):
        seen[0] += 1
        if seen[0] != 4:
            orig(self, row)

    monkeypatch.setattr(beams._Sink, "write", lossy)
    result = _run("power.beams")
    assert result["correct"] is False
    assert result["check"]["missing_records"]["value"] == 1


@pytest.mark.card
def test_control_fails_on_the_card():
    """On a card, at 1024 frames x 48 chunks: the program is correct and
    the control is not, through the same driver."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import control as C
    size = {"ndf": 1024, "nchk": 48}
    for cell in ("power.resident", "pfb1024.resident"):
        for which, want in (("program", True), ("control", False)):
            (_, res), = C.readings(cell, [7], 1.0, which,
                                   torch.device("cuda", 0), size)
            assert res["correct"] is want, (cell, which, res["check"])
