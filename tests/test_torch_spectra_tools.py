"""The port's spectra benchmark (``tools/spectra_bench.py``) and streaming
probe (``probes/streaming.py``) on the CPU, against the JAX package's
``benchmarks/spectra_bench.py`` and ``benchmarks/probe_streaming.py``.

Every step of the benchmark runs two chained blocks (the carry between
them) through the port's step, on the plain versions, and through the
JAX function the script calls at that step: ``pfb_spectra_fused`` in
interpret mode for the streaming PFB (64 frames x 2 chunks); for the
composed modes, whose windows per spectrum the fused kernel takes only at
thousands of frames (a multiple of 8, at least 8), its XLA twin
``ops/pfb.py:pfb_spectra`` on one chunk at the fewest frames the mode
admits (rows blocks turned to 6-D by the JAX package's
``frame.rows_to_block``); the coarse rows kernels in interpret mode (power
and Stokes at nout 1 and 64, 64 frames) and, at nout 1024, their XLA
wire twins on 1024 frames; and the torch.fft comparison row against
``make_streaming_pfb(1024, 4, method="fft")``. The PFB agrees within
2e-5 peak-normalized (``benchmarks/parity_tpu.py:BOUND_PFB``), the
coarse sums to the bit (int16 in [-16, 16]: every float32 partial sum
of the JAX functions is then exact). The probe's five steps A-E are held
against the JAX script's five calls, and the reports' keys and labels
against the JAX scripts' source.
"""

from __future__ import annotations

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paf_baseband2power_tpu.ops import frame as JF
from paf_baseband2power_tpu.ops import pallas_power as PP
from paf_baseband2power_tpu.ops import pfb as JPF
from paf_baseband2power_tpu.ops import power as JP
from paf_baseband2power_tpu.ops.pallas_pfb import pfb_spectra_fused
from paf_baseband2power_tpu_torch.ops import pfb as PF
from paf_baseband2power_tpu_torch.probes import streaming as ST
from paf_baseband2power_tpu_torch.tools import spectra_bench as SB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_PFB = 2e-5
NTAP = 4
# the fewest frames each composed mode admits (windows per spectrum >=
# ntap - 1 and nout dividing the windows)
COMPOSED_NDF = {(128, 64, False): 256, (128, 1024, False): 3072,
                (128, 1, True): 64, (128, 64, True): 256,
                (1024, 64, False): 1536, (256, 8, True): 64}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the small CPU blocks (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(layout: str, ndf: int, nchk: int, seed: int,
          exact: bool = False) -> np.ndarray:
    shape = ((ndf, nchk * 3584) if layout == "wire"
             else (nchk * 14, ndf, 256))
    lo, hi = (-16, 17) if exact else (-256, 256)
    return np.random.default_rng(seed).integers(lo, hi, size=shape,
                                                dtype=np.int16)


def _as_6d(x: np.ndarray, layout: str, ndf: int, nchk: int) -> np.ndarray:
    """A block of either layout as the canonical 6-D block the JAX XLA
    spectrometer takes."""
    if layout == "wire":
        return x.reshape(ndf, nchk, 128, 7, 2, 2)
    return JF.rows_to_block(x, ndf, nchk)


def _err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def _port(step, blocks):
    return [step(torch.from_numpy(b)).numpy() for b in blocks]


def _jax(step2, blocks):
    """A JAX streaming ``step2(x, carry) -> (out, carry)`` over blocks."""
    outs, carry = [], None
    for x in blocks:
        out, carry = step2(jnp.asarray(x), carry)
        outs.append(np.asarray(out))
    return outs


def _dict_keys(script: str, where) -> list[set[str]]:
    """The key sets of the dict literals in ``benchmarks/<script>`` that
    ``where(node)`` picks, in source order."""
    with open(os.path.join(REPO, "benchmarks", script)) as f:
        tree = ast.parse(f.read())
    found = [node for node in ast.walk(tree)
             if isinstance(node, ast.Dict) and where(node)]
    found.sort(key=lambda n: (n.lineno, n.col_offset))
    return [{k.value for k in node.keys} for node in found]


def _has_key(name: str):
    return lambda node: any(isinstance(k, ast.Constant) and k.value == name
                            for k in node.keys)


# --- spectra_bench: each step against the JAX function the script calls -----


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft", SB.STREAM_NFFTS)
def test_streaming_pfb_step_equals_pfb_spectra_fused(nfft, layout):
    blocks = [_draw(layout, 64, 2, seed) for seed in (1, 2)]
    got = _port(SB.fused_step(nfft, 1, False, layout), blocks)
    want = _jax(lambda x, h: pfb_spectra_fused(
        x, nfft, NTAP, history=h, return_history=True, layout=layout,
        interpret=True), blocks)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _err(g, w) < BOUND_PFB


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft,nout,stokes", SB.COMPOSED)
def test_composed_step_equals_the_xla_spectrometer(nfft, nout, stokes,
                                                   layout):
    ndf = COMPOSED_NDF[(nfft, nout, stokes)]
    blocks = [_draw(layout, ndf, 1, seed) for seed in (3, 4)]
    got = _port(SB.fused_step(nfft, nout, stokes, layout), blocks)
    want = _jax(lambda x, h: JPF.pfb_spectra(
        x, nfft, NTAP, nout=nout, stokes=stokes, history=h,
        return_history=True), [_as_6d(b, layout, ndf, 1) for b in blocks])
    for g, w in zip(got, want):
        assert g.shape == w.shape and _err(g, w) < BOUND_PFB


def _jax_coarse(stokes: bool, nout: int, x: np.ndarray, ndf: int):
    """The JAX script's rows kernel (interpret mode) or, at nout 1024, its
    XLA twin on the same frames as a wire block."""
    if nout == 1024:
        w = jnp.asarray(_as_6d(x, "rows", ndf, 1).reshape(ndf, -1))
        return (JP.baseband2stokes_scrunch_2d(w, nout) if stokes
                else JP.baseband2power_scrunch_2d(w, nout))
    fn = (PP.baseband2stokes_scrunch_rows_pallas if stokes
          else PP.baseband2power_scrunch_rows_pallas)
    return fn(jnp.asarray(x), nout, interpret=True)


@pytest.mark.parametrize("stokes,nout",
                         [(False, n) for n in SB.COARSE_POWER_NOUTS]
                         + [(True, n) for n in SB.COARSE_STOKES_NOUTS])
def test_coarse_rows_step_equals_the_jax_kernel(stokes, nout):
    ndf = 1024 if nout == 1024 else 64
    for seed in (5, 6):
        x = _draw("rows", ndf, 1, seed, exact=True)
        got = SB.coarse_step(stokes, nout)(torch.from_numpy(x)).numpy()
        want = np.asarray(_jax_coarse(stokes, nout, x, ndf))
        assert got.shape == want.shape
        assert np.array_equal(got, want)


def test_torch_fft_row_equals_the_xla_streaming_pfb():
    blocks = [_draw("wire", 64, 2, seed) for seed in (7, 8)]
    got = _port(SB.torch_fft_step(SB.TORCH_FFT_NFFT), blocks)
    want = _jax(JPF.make_streaming_pfb(SB.TORCH_FFT_NFFT, NTAP,
                                       method="fft"), blocks)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _err(g, w) < BOUND_PFB


@pytest.mark.parametrize("layout", ["wire", "rows"])
@pytest.mark.parametrize("nfft,nout,stokes", [(128, 1024, False),
                                              (1024, 64, False)])
def test_quick_geometry_refuses_what_the_jax_kernel_refuses(nfft, nout,
                                                            stokes, layout):
    """At ``--quick``'s 1024 frames these two modes leave fewer windows per
    spectrum than the spectrometers take: both raise ValueError, so both
    scripts stop at the first of them."""
    x = _draw(layout, SB.QUICK_NDF, 1, 9)
    with pytest.raises(ValueError):
        SB.fused_step(nfft, nout, stokes, layout)(torch.from_numpy(x))
    with pytest.raises(ValueError):
        pfb_spectra_fused(jnp.asarray(x), nfft, NTAP, nout=nout,
                          stokes=stokes, return_history=True, layout=layout,
                          interpret=True)


def test_quick_run_stops_at_the_first_refused_mode(monkeypatch, tmp_path):
    """The JAX script's wire pass runs the XLA row, the four streaming
    sizes and the composed modes in order, and stops at ``(128, 1024)``;
    the port's does the same and writes no report."""
    seen = []

    def once(step, block, wrapper, timing=SB.TIMING):
        step(block)
        return 1e-3

    monkeypatch.setattr(SB, "time_step", once)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="windows per spectrum 1 "):
        SB.measure_all(SB.QUICK_NDF, 1, torch.device("cpu"), log=seen.append)
    modes = [json.loads(s).get("mode", json.loads(s).get("nfft"))
             for s in seen]
    assert modes == [1024, 128, 256, 512, 1024, "pfb+waterfall[64]"]
    assert not list(tmp_path.iterdir())


def test_reports_keys_and_labels_equal_the_jax_scripts(monkeypatch,
                                                       tmp_path, capsys):
    """Every row once at the smallest block all of them take; the three
    reports carry the JAX artifacts' keys (and ``device``), the rows the
    JAX rows' keys and labels, in the JAX order."""
    calls = []

    def once(step, block, wrapper, timing=SB.TIMING):
        step(block)
        calls.append(wrapper)
        return 1e-3

    monkeypatch.setattr(SB, "time_step", once)
    monkeypatch.chdir(tmp_path)
    assert SB.main(["--platform", "cpu", "--ndf", "3072", "--nchk", "1"]) \
        == 0
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    want = _dict_keys("spectra_bench.py", _has_key("what"))
    got = {stem: json.loads((tmp_path / f"{stem}_cpu.json").read_text())
           for stem in ("PFB", "COMPOSE", "DEVICE_LAYOUT")}
    for (stem, report), keys in zip(got.items(), want):
        assert set(report) == keys | {"device"}, stem
    assert got["PFB"]["device"] == {"platform": "cpu", "kind": "cpu"}
    pfb, comp = got["PFB"]["measurements"], got["COMPOSE"]["measurements"]
    assert got["DEVICE_LAYOUT"]["measurements"] == {"pfb_streaming": pfb,
                                                    "composed": comp}
    assert printed == pfb[:5] + comp[:6] + pfb[5:] + comp[6:]
    assert len(pfb) == 9 and len(comp) == 17 and len(calls) == 26
    row_keys = {"block_ms", "x_realtime", "samples_per_sec"}
    assert [(r["nfft"], r["layout"]) for r in pfb] == \
        [(1024, "wire")] + [(n, lay) for lay in ("wire", "rows")
                            for n in (128, 256, 512, 1024)]
    assert all(set(r) == {"nfft", "layout", "method"} | row_keys
               for r in pfb)
    # the JAX script's mode labels, computed as it computes them
    jax_modes = [("pfb" + ("+stokes" if s else "")
                  + (f"+waterfall[{n}]" if n > 1 else ""))
                 for _, n, s in SB.COMPOSED] * 2
    jax_modes += [("power" + (f"+waterfall[{n}]" if n > 1 else "")
                   + " (coarse channels, rows kernel)") for n in (1, 64)]
    jax_modes += [("stokes" + (f"+waterfall[{n}]" if n > 1 else "")
                   + " (coarse channels, rows pair-product kernel)")
                  for n in (1, 64, 1024)]
    assert [r["mode"] for r in comp] == jax_modes
    assert all(set(r) == {"nfft", "nout", "stokes", "layout", "mode"}
               | row_keys for r in comp)
    assert calls[0] == "pfb_torch" and calls[-5:] == (
        ["baseband2power_scrunch_rows_cuda"] * 2
        + ["baseband2stokes_scrunch_rows_cuda"] * 3)


def test_spectra_bench_needs_a_gpu_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        SB.main([])
    assert e.value.code == 2


# --- probe_streaming ---------------------------------------------------------


def _jax_steps(rows, nfft: int) -> dict:
    """The JAX script's five steps on ``rows`` (interpret mode)."""
    def run(**kw):
        return pfb_spectra_fused(rows, nfft, NTAP, layout="rows",
                                 interpret=True, **kw)

    _, h0 = run(return_history=True)
    state = {"h": h0}

    def e_step():
        out, state["h"] = run(history=state["h"], return_history=True)
        return out

    return dict(zip(ST.LABELS, (
        lambda: run(), lambda: run(return_history=True),
        lambda: run(history=h0),
        lambda: run(history=h0, return_history=True), e_step)))


@pytest.mark.parametrize("nfft", [128, 1024])
def test_streaming_steps_equal_the_jax_scripts(nfft):
    rows = _draw("rows", 64, 2, 10)
    got = ST.make_steps(torch.from_numpy(rows), nfft)
    want = _jax_steps(jnp.asarray(rows), nfft)
    assert list(got) == list(want)
    for label in ST.LABELS:
        runs = 2 if label.startswith("E") else 1   # E: a carry of its own
        for _ in range(runs):
            g, w = got[label](), want[label]()
        if isinstance(g, tuple):
            (g, gh), (w, wh) = g, w
            assert torch.equal(gh, PF.history_from_jax(np.asarray(wh),
                                                       NTAP, nfft))
        assert _err(g.numpy(), np.asarray(w)) < BOUND_PFB, label


def test_streaming_labels_equal_the_jax_scripts(capsys):
    with open(os.path.join(REPO, "benchmarks", "probe_streaming.py")) as f:
        tree = ast.parse(f.read())
    labels = [node.targets[0].slice.value for node in ast.walk(tree)
              if isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name)
              and node.targets[0].value.id == "results"]
    assert list(ST.LABELS) == labels
    assert ST.main(["--platform", "cpu", "--ndf", "64", "--nfft", "128",
                    "--iters", "1"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert set(line) == {"nfft", "ndf", "ms"}
    assert (line["nfft"], line["ndf"]) == (128, 64)
    assert list(line["ms"]) == labels and all(v > 0
                                              for v in line["ms"].values())
