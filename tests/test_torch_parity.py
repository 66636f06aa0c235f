"""The port's parity sweeps (``paf_baseband2power_tpu_torch/parity.py``) and
its copies of the float64 goldens (``ops/golden.py``, ``ops/pfb_golden.py``)
on the CPU, against the JAX package.

The goldens are equal to the JAX package's, array for array, on seeded
blocks. The sweeps have the JAX sweeps' mode names (read from the JAX
package's own reports, ``benchmarks/PARITY_TPU_r05.json`` and
``benchmarks/PARITY_FULL_r05.json``, which nothing here changes), pass on
the CPU, where the CUDA wrappers take their plain versions, and their
cases give the JAX functions' outputs on the same inputs. The rest holds
the sweep's rules: a case that raises is recorded and the exit is
nonzero, ``--platform cuda`` without a card is a usage error (exit 2), a
case on the card that launched no kernel fails, and the report is valid
JSON after every case.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import parity_full as JFULL
from benchmarks import parity_tpu as JSWEEP
from paf_baseband2power_tpu.ops import golden as JG
from paf_baseband2power_tpu.ops import pallas_power as PP
from paf_baseband2power_tpu.ops import pfb as JPF
from paf_baseband2power_tpu.ops.pallas_pfb import pfb_spectra_fused
from paf_baseband2power_tpu_torch import parity
from paf_baseband2power_tpu_torch.ops import cuda_power as CP
from paf_baseband2power_tpu_torch.ops import frame as F
from paf_baseband2power_tpu_torch.ops import golden as G
from paf_baseband2power_tpu_torch.ops import pfb_golden as PG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small CPU blocks here (restored after):
    under several test workers, many threads on small tensors swamp the
    calls in scheduling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_report(name: str) -> dict:
    with open(os.path.join(REPO, "benchmarks", name)) as f:
        return json.load(f)


# --- the golden copies --------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("baseband2power_golden", {}),
    ("baseband2power_golden", dict(mean=True)),
    ("baseband2power_scrunch_golden", dict(nout=1)),
    ("baseband2power_scrunch_golden", dict(nout=4, mean=True)),
    ("baseband2stokes_golden", {}),
    ("baseband2stokes_golden", dict(mean=True)),
    ("baseband2stokes_scrunch_golden", dict(nout=1)),
    ("baseband2stokes_scrunch_golden", dict(nout=8, mean=True))])
def test_direct_golden_copies_equal(name, kw):
    block = F.synthetic_block(rng=7, ndf=16, nchk=2, scale=3000.0)
    got, want = getattr(G, name)(block, **kw), getattr(JG, name)(block, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert G.expected_output_nbytes(3) == JG.expected_output_nbytes(3)


@pytest.mark.parametrize("window", ["hamming", "hanning", "rect"])
@pytest.mark.parametrize("nfft,ntap", [(32, 4), (128, 8), (16, 1)])
def test_pfb_coeffs_and_channelizer_copies_equal(window, nfft, ntap):
    for dtype in (np.float32, np.float64):
        c, jc = (m.pfb_coeffs(nfft, ntap, window, dtype) for m in (PG, JPF))
        assert c.dtype == jc.dtype and np.array_equal(c, jc)
    rng = np.random.default_rng(nfft)
    x = rng.normal(size=(2, 3, 8 * nfft)) + 1j * rng.normal(size=(2, 3,
                                                                  8 * nfft))
    c = PG.pfb_coeffs(nfft, ntap, window, np.float64)
    assert np.array_equal(PG.channelize_golden(x, c),
                          JPF.channelize_golden(x, c))


@pytest.mark.parametrize("nfft,nout,stokes,mean", [
    (32, 1, False, False), (32, 4, True, True), (128, 1, True, False),
    (128, 2, False, True), (64, 8, True, False)])
def test_pfb_golden_copies_equal(nfft, nout, stokes, mean):
    block = F.synthetic_block(rng=nfft + nout, ndf=32, nchk=1)
    kw = dict(nout=nout, stokes=stokes, mean=mean)
    got = PG.pfb_spectra_golden(block, nfft, 4, **kw)
    assert np.array_equal(got, JPF.pfb_spectra_golden(block, nfft, 4, **kw))
    if nout == 1 and not stokes:
        for shift in (False, True):
            got = PG.pfb_power_golden(block, nfft, 4, mean=mean, shift=shift)
            assert np.array_equal(got, JPF.pfb_power_golden(
                block, nfft, 4, mean=mean, shift=shift))


def test_sweep_helpers_equal_the_jax_sweeps():
    """``_err``, the host corner turn (the port's ``block_to_rows`` in place
    of the JAX sweep's ``_to_rows``) and ``_chunk_golden``."""
    rng = np.random.default_rng(3)
    got, want = rng.normal(size=(4, 50)), rng.normal(size=(4, 50))
    assert parity._err(got, want) == JSWEEP._err(got, want)
    assert parity._err(got, np.zeros(3)) == JSWEEP._err(got, np.zeros(3))
    block = F.synthetic_block(rng=4, ndf=8, nchk=3)
    assert np.array_equal(F.block_to_rows(block), JSWEEP._to_rows(block))
    want = JFULL._chunk_golden(JG.baseband2stokes_golden, block)
    assert np.array_equal(
        parity._chunk_golden(G.baseband2stokes_golden, block), want)


# --- the sweeps ---------------------------------------------------------------


def _meta(row: dict) -> dict:
    return {k: row[k] for k in ("nfft", "nout", "stokes", "layout",
                                "streaming") if k in row}


@pytest.mark.parametrize("kind", ["sweep", "full"])
def test_mode_names_equal_the_jax_reports(kind):
    """``run_sweep(nout_fine=64)``'s 75 modes and ``run_full``'s 15, in
    the JAX sweeps' order, with the cross's fields."""
    blocks = parity.Blocks(4096, 2, (1001, 1002), CPU)  # never generated
    if kind == "sweep":
        cases, report = (parity.sweep_cases(blocks, 64),
                         _jax_report("PARITY_TPU_r05.json"))
    else:
        cases, report = (parity.full_cases(blocks),
                         _jax_report("PARITY_FULL_r05.json"))
    assert len(cases) == {"sweep": 75, "full": 15}[kind]
    assert [c.mode for c in cases] == [r["mode"] for r in report["cases"]]
    assert [c.meta for c in cases] == [_meta(r) for r in report["cases"]]
    assert [c.bound for c in cases] == [r["bound"] for r in report["cases"]]
    assert not blocks._host


def test_cpu_sweep_at_its_smallest_size_is_all_ok(tmp_path):
    """Every case at the smallest block that admits them all at nout 8:
    512 frames (``scrunch[512]`` needs whole windows; nfft 1024 x 8
    spectra need 3 windows each), one chunk."""
    out = tmp_path / "sweep.json"
    report = parity.run_sweep(512, 1, str(out), 8, CPU)
    assert report["ok"] and len(report["cases"]) == 75
    assert report["backend"] == "cpu" and report["device"]["platform"] == "cpu"
    assert json.loads(out.read_text()) == report
    for row in report["cases"]:
        assert row["ok"] and row["err"] <= row["bound"] and row["wrapper"]
        assert row["launches"] == 0          # the plain versions count none
    direct = [r["err"] for r in report["cases"][:9]]
    assert max(direct) < 1e-7                # exact sums, rounded once


def test_full_sweep_with_its_goldens_in_a_pool(tmp_path):
    """``run_full``'s 15 cases at 256 x 2 (``scrunch[256]`` needs 256
    frames), the goldens chunk by chunk in two processes."""
    report = parity.run_full(str(tmp_path / "full.json"), 256, 2, CPU)
    assert report["ok"] and len(report["cases"]) == 15
    assert [r["mode"] for r in report["cases"]] == \
        [r["mode"] for r in _jax_report("PARITY_FULL_r05.json")["cases"]]
    for row in report["cases"]:
        assert row["kernel_sec"] >= 0 and row["golden_sec"] >= 0
    assert all(row["err"] == 0.0 for row in report["cases"][:7])   # exact


def _jax_output(mode: str, blocks: parity.Blocks) -> np.ndarray:
    """The JAX function the JAX sweep calls for ``mode``, in interpret
    mode, on the same host blocks."""
    if mode == "power wire":
        return PP.baseband2power_pallas(jnp.asarray(blocks.host("wire1")),
                                        interpret=True)
    if mode == "stokes x scrunch[64] rows":
        return PP.baseband2stokes_scrunch_rows_pallas(
            jnp.asarray(blocks.host("rows1")), 64, interpret=True)
    kw = dict(stokes=True, layout="rows", interpret=True)
    _, h1 = pfb_spectra_fused(jnp.asarray(blocks.host("rows1")), 1024, 4,
                              return_history=True, **kw)
    return pfb_spectra_fused(jnp.asarray(blocks.host("rows2")), 1024, 4,
                             history=h1, **kw)


@pytest.mark.parametrize("mode,first,bound", [
    ("power wire", None, parity.BOUND_DIRECT),
    ("stokes x scrunch[64] rows", None, parity.BOUND_DIRECT),
    ("pfb 1024 x stokes rows streaming", "pfb 1024 x stokes rows one-shot",
     parity.BOUND_PFB)])
def test_cases_give_the_jax_functions_outputs(mode, first, bound):
    """A case's output against the JAX function on the same input, within
    the sweep's own bound for its family (peak-normalized): the JAX
    functions sum in float32 (the PFB through bf16x3 products)."""
    blocks = parity.Blocks(512, 1, (1001, 1002), CPU)
    cases = {c.mode: c for c in parity.sweep_cases(blocks, 8)}
    if first is not None:           # the one-shot case holds the carry
        cases[first].run(blocks.card(cases[first].block))
    case = cases[mode]
    got = case.run(blocks.card(case.block)).numpy()
    want = np.asarray(_jax_output(mode, blocks))
    assert got.shape == want.shape
    assert parity._err(got, want) <= bound


def test_a_raising_case_is_recorded_and_the_exit_is_nonzero(
        monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(CP, "baseband2power_cuda", boom)
    out = tmp_path / "r.json"
    rc = parity.main(["--platform", "cpu", "--ndf", "16", "--nchk", "1",
                      "--cases", "^(power|stokes) wire$", "--out", str(out)])
    assert rc == 1
    rows = json.loads(out.read_text())["cases"]
    assert [r["mode"] for r in rows] == ["power wire", "stokes wire"]
    assert rows[0]["ok"] is False and rows[0]["error"] == "RuntimeError: boom"
    assert rows[1]["ok"] is True          # the sweep went on
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": False, "cases": 2, "failed": ["power wire"]}


def test_cuda_without_a_card_is_a_usage_error(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        parity.main(["--out", str(tmp_path / "x.json")])
    assert e.value.code == 2
    assert not (tmp_path / "x.json").exists()


def test_no_matching_case_is_a_usage_error(tmp_path):
    with pytest.raises(SystemExit) as e:
        parity.main(["--platform", "cpu", "--cases", "no such mode",
                     "--out", str(tmp_path / "x.json")])
    assert e.value.code == 2


def test_report_is_valid_json_after_every_case(monkeypatch, tmp_path):
    out = tmp_path / "c.json"
    seen = []
    replace = os.replace

    def checked(src, dst):
        replace(src, dst)
        seen.append(len(json.loads(out.read_text())["cases"]))

    monkeypatch.setattr(os, "replace", checked)
    report = parity.run_sweep(16, 1, str(out), 8, CPU,
                              cases="^pfb 128 (wire|rows)")
    assert report["ok"] and len(report["cases"]) == 4
    assert seen == [1, 2, 3, 4, 4]           # each case, then the end


class _CardBlocks(parity.Blocks):
    """Blocks that claim to be on a card but stay on the CPU, where no
    wrapper launches a kernel."""

    def __init__(self):
        super().__init__(16, 1, (1, 2), torch.device("cuda"))

    def card(self, name):
        return torch.from_numpy(self.host(name))


def test_a_case_that_launched_no_kernel_fails_on_the_card(tmp_path):
    blocks = _CardBlocks()
    cases = [c for c in parity.sweep_cases(blocks, 1)
             if c.mode == "power wire"]
    report = parity._run({"cases": []}, cases, blocks,
                         str(tmp_path / "n.json"), "sec")
    row, = report["cases"]
    assert row["ok"] is False and report["ok"] is False
    assert row["error"] == ("RuntimeError: baseband2power_cuda launched no "
                            "kernel")
