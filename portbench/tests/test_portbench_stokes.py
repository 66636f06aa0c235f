"""The full-Stokes PFB configuration and the PFB under four beams, on the
CPU at a tiny block through the port's plain versions: both new cells are
correct, the Stokes carry chains across the pool's rotation, the Stokes
reference agrees with the PFB power reference and with the executor, the
bfloat16 control fails the configuration's limit, and the PFB finish's
metric reads nothing where no kernel is launched. On a card (marker
``card``) that metric reads the finish's device time."""

import numpy as np
import pytest
import torch
from _tiny import TINY

from portbench import check, control, gen, run
from portbench.references import pfb as RPFB
from portbench.references import pfb_stokes as RPS
from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline

NEW = ("pfb1024_stokes.resident", "pfb1024.beams")
SEED = 2**31 + 77


def _run(cell, seed=SEED, traced=False, **kw):
    return run.run_cell(run.load_manifest(), cell, seed, 0.3, traced,
                        torch.device("cpu"), cfg_override=TINY, **kw)


def _cfg(name="paf_bmf_pfb1024_stokes", **pipeline):
    cfg = dict(run.load_config(run.load_manifest(), name), **TINY)
    cfg["pipeline"] = dict(cfg["pipeline"], **pipeline)
    return cfg


def _peak_err(got, ref) -> float:
    return check.Expected(ref).error("peak", got)


@pytest.mark.parametrize("cell", NEW)
def test_new_cell_finds_its_files(cell):
    manifest = run.load_manifest()
    work = run.find(manifest["workloads"], cell, "workload")
    assert work["chips"] == 1 and len(work["why"]) <= 200
    cfg = run.load_config(manifest, work["config"])
    assert cfg["name"] == work["config"]
    assert hasattr(run.load_driver(run.load_traffic(work["traffic"])
                                   ["driver"]), "setup")
    reported = {m["name"] for m in run.cell_metrics(manifest, cell, False)}
    assert "setup_s" in reported and len(reported) >= 2
    per_layer = run.cell_metrics(manifest, cell, True)
    assert per_layer and all(m["moves"] in reported for m in per_layer)
    for m in run.cell_metrics(manifest, cell, False) + per_layer:
        assert callable(run.load_reader(m["name"]).read)


@pytest.mark.parametrize("cell", NEW)
def test_new_cell_records_equal_the_reference(cell):
    result, _ = _run(cell)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and result["attempted"] > 3
    assert result["check"]["missing_records"]["value"] == 0


def test_stokes_records_chain_the_carry(monkeypatch):
    """The resident Stokes stream, worked out block after block by the
    reference with each previous block's tail, matches what the program
    delivered; the first record (no carry) differs from a later record of
    the same block (with one)."""
    kept = {}
    orig = check.compare

    def spy(cfg, streams, pool_block):
        kept.update(streams=streams, pool=pool_block, cfg=cfg)
        return orig(cfg, streams, pool_block)

    monkeypatch.setattr(check, "compare", spy)
    result, _ = _run("pfb1024_stokes.resident")
    assert result["correct"]
    (s,), cfg = kept["streams"], kept["cfg"]
    assert len(s.records) > 4 and len(set(s.sent)) == 3
    assert s.records[0].shape == (1, 4, TINY["nchk"] * 7 * 1024)
    halo = None
    for i, got in enumerate(s.records[:5]):
        block = kept["pool"](s.sent[i])
        ref = RPS.stokes(block, halo, cfg).numpy()
        assert _peak_err(got, ref) <= cfg["compare"]["limit"]
        halo = RPFB.tail(block, cfg)
    again = s.sent.index(s.sent[0], 1)
    assert np.abs(s.records[0] - s.records[again]).max() > 0


@pytest.mark.parametrize("carry", [False, True])
def test_stokes_i_plane_is_the_power_record(carry):
    """I of the Stokes reference equals the PFB power reference's record
    of the same block, to float32 rounding."""
    cfg = _cfg()
    prev, block = gen.make_pool(cfg, 2, 2**33 + 1, torch.device("cpu"))
    prev = prev if carry else None
    stokes = RPS.record(block, prev, cfg)
    power = RPFB.record(block, prev, _cfg("paf_bmf_pfb1024"))
    assert stokes.shape == (1, 4, power.size)
    np.testing.assert_allclose(stokes[0, 0], power, rtol=2**-23, atol=0)
    # Q, U and V are signed: noise averages them well below I
    assert np.abs(stokes[0, 1:]).max() < stokes[0, 0].max()


@pytest.mark.parametrize("nfft", [64, 1024])
def test_executor_stokes_matches_the_reference(nfft):
    """``PowerPipeline(stokes=True)`` over a chain of 3 seeded blocks, carry
    included, against the float64 reference, within the configuration's
    limit."""
    cfg = _cfg(pfb_nfft=nfft)
    pipe = PowerPipeline("cpu", **cfg["pipeline"])
    blocks = gen.make_pool(cfg, 3, 2**32 + nfft, torch.device("cpu"))
    halo = None
    for block in blocks:
        got = pipe.power(block).numpy()
        ref = RPS.stokes(block, halo, cfg).numpy()
        assert got.shape == ref.shape == (1, 4, TINY["nchk"] * 7 * nfft)
        assert _peak_err(got, ref) <= cfg["compare"]["limit"]
        halo = RPFB.tail(block, cfg)


def test_control_fails_the_limit():
    """The reference in bfloat16 through the same driver is not correct,
    by far more than the limit."""
    (_, res), = control.readings("pfb1024_stokes.resident", [SEED], 0.3,
                                 "control", torch.device("cpu"), TINY)
    err = res["check"]["peak_err"]
    assert res["correct"] is False
    assert err["value"] > 10 * err["limit"]


def test_traced_cpu_run_reports_no_pfb_finish():
    """The plain route launches nothing on a card, so the metric is left
    out of the line; the step's own span is still read."""
    result, _ = _run("pfb1024_stokes.resident", traced=True)
    assert result["correct"], result["check"]
    assert "pfb_finish_ms.resident" not in result["metrics"]
    assert result["metrics"]["dispatch_ms.resident"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["pfb1024_stokes.resident",
                                  "pfb1024.resident"])
def test_pfb_finish_ms_reads_on_the_card(cell):
    """A traced run at 1024 frames x 48 chunks on the card reads the
    finish's device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, _ = run.run_cell(run.load_manifest(), cell, SEED, 1.0, True,
                             torch.device("cuda", 0),
                             cfg_override={"ndf": 1024, "nchk": 48})
    assert result["correct"], result["check"]
    got = result["metrics"].get("pfb_finish_ms.resident")
    assert got is not None and got["value"] > 0, result["metrics"]


class _Event:
    def __init__(self, name, a, b, corr=0, cuda=False, annotation=False):
        self._n, self._a, self._b, self._c = name, a, b, corr
        self._cuda, self._ann = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._ann


def _finish_ms(monkeypatch, events):
    """``pfb_finish_ms.resident`` over ``events`` of a profiler, two window
    blocks in a window of [0, 1000) ns."""
    from portbench.stream import Clock, Stream
    reader = run.load_reader("pfb_finish_ms.resident")
    results = type("R", (), {"events": lambda _: events})()
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": results})()})()
    monkeypatch.setattr(reader, "_caller_profiler", lambda: prof)
    stream = Stream(sent=[0, 1], records=[0, 1])
    ctx = run.Context("pfb1024_stokes.resident", {}, {}, [stream],
                      Clock(t0_ns=0, t1_ns=1000), 0.0, object())
    return reader.read(ctx)


def test_pfb_finish_ms_links_launches_inside_the_span(monkeypatch):
    """Only the device operation of a launch inside the span counts,
    linked by correlation id (a host op of the same id is no launch), and
    only its part inside the window."""
    events = [
        _Event("pafb2p.pfb.finish", 100, 200),
        _Event("pafb2p.pfb.finish", 100, 200, cuda=True, annotation=True),
        _Event("cudaLaunchKernel", 150, 160, corr=7),
        _Event("aten::empty", 120, 130, corr=8),
        _Event("cudaLaunchKernel", 250, 260, corr=9),
        _Event("pfb_finish_kernel", 300, 500, corr=7, cuda=True),
        _Event("other", 500, 900, corr=8, cuda=True),
        _Event("pfb_kernel_wide", 900, 1300, corr=9, cuda=True),
    ]
    assert _finish_ms(monkeypatch, events) == pytest.approx(200 / 1e6 / 2)


def test_pfb_finish_ms_without_the_span_is_none(monkeypatch):
    events = [_Event("cudaLaunchKernel", 150, 160, corr=7),
              _Event("pfb_finish_kernel", 300, 500, corr=7, cuda=True)]
    assert _finish_ms(monkeypatch, events) is None
    events.insert(0, _Event("pafb2p.pfb.finish", 400, 450))
    assert _finish_ms(monkeypatch, events) is None    # no launch inside
