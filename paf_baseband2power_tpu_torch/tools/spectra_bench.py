"""PFB and composed-spectra benchmark on one card.

The counterpart of the JAX package's ``benchmarks/spectra_bench.py``: the
streaming PFB spectrometer at nfft 128/256/512/1024, the six composed
modes of ``COMPOSED`` (PFB x waterfall x Stokes) and the coarse rows
kernels (power at nout 1 and 64, Stokes at nout 1, 64 and 1024), on full
8192 x 48 blocks drawn on the card, in both device layouts: wire (frames x
lanes, as the capture engine writes them) and rows (the capture engine's
``--device-layout`` series rows, ``(672, ndf, 256)``). Every step runs a
CUDA wrapper: ``pfb_spectra_cuda`` (the carry chained from call to call
as a stream runs it), ``baseband2power_scrunch_rows_cuda`` or
``baseband2stokes_scrunch_rows_cuda``; a row whose wrapper launched no
kernel on the card is an error. One comparison row runs the PFB at nfft
1024 on wire through ``torch.fft`` on the card (``ops/cuda_pfb.py:
pfb_power_torch``, the executor's route for the shapes the kernel does not
take), the counterpart of the JAX script's XLA row; if it fails it is
printed as skipped.

Only one full block lives at a time (the wire pass, then the rows pass),
and each call's output is dropped as the next is made. Time per block is
the two-point slope on the card's clock (CUDA events; the host's clock on
the CPU), the best of 4 repeats at 2 and at 8 calls after two warm-up
calls (the torch.fft row: 2 repeats at 2 and 4), as the JAX script times
it.

    python -m paf_baseband2power_tpu_torch.tools.spectra_bench [--quick]
        [--platform {cuda,cpu}] [--ndf N] [--nchk N]

``--quick``: 1024 frames. There, as in the JAX script, the composed
``(128, 1024)`` and ``(1024, 64)`` modes leave fewer windows per spectrum
than ``ntap - 1`` and the run stops with the spectrometer's ValueError.
``--ndf``/``--nchk`` set another block (``--platform cpu --ndf 3072
--nchk 1`` is the smallest that every row takes). Each row is printed as
a JSON line; the reports ``PFB_<platform>.json``,
``COMPOSE_<platform>.json`` and ``DEVICE_LAYOUT_<platform>.json`` (the JAX
artifacts' keys, and ``device``: the card's name and power limit) are
written to the current directory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import constants as C
from ..bench import measure
from ..ops import cuda_pfb as CF
from ..ops import cuda_power as CP
from ..ops import pfb as PF
from ..probes._common import (add_platform, card, device_for,
                              make_block_2d, make_block_rows)

BASE = 796.4e6  # complex samples/s per node (BASELINE.md)
NTAP = 4
STREAM_NFFTS = (128, 256, 512, 1024)
COMPOSED = ((128, 64, False), (128, 1024, False), (128, 1, True),
            (128, 64, True), (1024, 64, False), (256, 8, True))
COARSE_POWER_NOUTS = (1, 64)
COARSE_STOKES_NOUTS = (1, 64, 1024)
TIMING = (2, 8, 4)          # calls at the slope's two points, repeats
TORCH_FFT_TIMING = (2, 4, 2)
TORCH_FFT_NFFT = 1024
QUICK_NDF = 1024
KERNEL_METHOD = ("CUDA per-warp FFT spectrometer (pfb_spectra_cuda, "
                 "streaming)")
TORCH_FFT_METHOD = ("batched-FFT spectrometer (torch.fft on the card, the "
                    "executor's route for the shapes the kernel does not "
                    "take)")


def fused_step(nfft: int, nout: int, stokes: bool, layout: str):
    """``step(block)``: ``pfb_spectra_cuda`` with the carry of the previous
    call (the JAX script's ``fused_step``)."""
    hist = {}

    def step(b):
        out, hist["h"] = CF.pfb_spectra_cuda(
            b, nfft, NTAP, nout=nout, stokes=stokes, history=hist.get("h"),
            return_history=True, layout=layout)
        return out

    return step


def torch_fft_step(nfft: int):
    """``step(block)``: the streaming PFB power through torch.fft, carry
    chained (the JAX script's XLA ``make_streaming_pfb(..., "fft")``)."""
    step2 = PF.make_streaming_pfb(nfft, NTAP, power=CF.pfb_power_torch)
    hist = {}

    def step(b):
        out, hist["h"] = step2(b, hist.get("h"))
        return out

    return step


def coarse_step(stokes: bool, nout: int):
    fn = (CP.baseband2stokes_scrunch_rows_cuda if stokes
          else CP.baseband2power_scrunch_rows_cuda)
    return lambda b: fn(b, nout)


def mode_label(nfft: int, nout: int, stokes: bool) -> str:
    """The JAX script's ``mode`` of a composed row."""
    if nfft:
        return ("pfb" + ("+stokes" if stokes else "")
                + (f"+waterfall[{nout}]" if nout > 1 else ""))
    if stokes:
        return ("stokes" + (f"+waterfall[{nout}]" if nout > 1 else "")
                + " (coarse channels, rows pair-product kernel)")
    return ("power" + (f"+waterfall[{nout}]" if nout > 1 else "")
            + " (coarse channels, rows kernel)")


def time_step(step, block: torch.Tensor, wrapper: str,
              timing=TIMING) -> float:
    """Seconds per call of ``step(block)`` (the bench's ``measure``);
    raises on the card if ``wrapper`` launched no kernel in the timed
    calls."""
    dt, launched = measure(step, block, *timing)
    if block.device.type == "cuda" and not launched.get(wrapper):
        raise RuntimeError(f"{wrapper} launched no kernel: {launched}")
    return dt


# the rows of each pass in order: (kind, nfft, nout, stokes); the wire
# pass starts with the torch.fft comparison row
WIRE_PASS = ([("torch.fft", TORCH_FFT_NFFT, 1, False)]
             + [("pfb", n, 1, False) for n in STREAM_NFFTS]
             + [("composed", *c) for c in COMPOSED])
ROWS_PASS = ([("pfb", n, 1, False) for n in STREAM_NFFTS]
             + [("composed", *c) for c in COMPOSED]
             + [("coarse", 0, n, False) for n in COARSE_POWER_NOUTS]
             + [("coarse", 0, n, True) for n in COARSE_STOKES_NOUTS])


def step_for(kind: str, nfft: int, nout: int, stokes: bool, layout: str):
    """``(step, wrapper, timing)`` of one row."""
    if kind == "torch.fft":
        return torch_fft_step(nfft), "pfb_torch", TORCH_FFT_TIMING
    if kind == "coarse":
        name = (f"baseband2{'stokes' if stokes else 'power'}"
                "_scrunch_rows_cuda")
        return coarse_step(stokes, nout), name, TIMING
    return fused_step(nfft, nout, stokes, layout), "pfb_spectra_cuda", TIMING


def measure_all(ndf: int, nchk: int, device: torch.device, log=print
                ) -> tuple[list, list]:
    """Both passes, each row logged as it is measured; returns
    ``(pfb_rows, comp_rows)``."""
    stream_sec = ndf * C.TDF_SEC
    samples = ndf * C.NSAMP_DF * nchk * C.NCHAN_CHK * C.NPOL_SAMP
    pfb_rows, comp_rows = [], []

    def row(dt, **kw):
        kw["block_ms"] = dt * 1e3
        kw["x_realtime"] = stream_sec / dt
        kw["samples_per_sec"] = samples / dt
        log(json.dumps(kw))
        return kw

    for layout, make, specs in (
            ("wire", make_block_2d, WIRE_PASS),
            ("rows", make_block_rows, ROWS_PASS)):
        block = make(ndf, device, seed=0 if layout == "wire" else 1,
                     nchk=nchk)
        for kind, nfft, nout, stokes in specs:
            step, wrapper, timing = step_for(kind, nfft, nout, stokes,
                                             layout)
            if kind == "torch.fft":
                try:
                    dt = time_step(step, block, wrapper, timing)
                except Exception as e:    # a reported row, not a fallback
                    log(f"torch.fft comparison row skipped: "
                        f"{type(e).__name__}: {e}")
                    continue
                finally:
                    del step
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                pfb_rows.append(row(dt, nfft=nfft, layout=layout,
                                    method=TORCH_FFT_METHOD))
                continue
            dt = time_step(step, block, wrapper, timing)
            if kind == "pfb":
                pfb_rows.append(row(dt, nfft=nfft, layout=layout,
                                    method=KERNEL_METHOD))
            else:
                comp_rows.append(row(dt, nfft=nfft, nout=nout,
                                     stokes=stokes, layout=layout,
                                     mode=mode_label(nfft, nout, stokes)))
        del block
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return pfb_rows, comp_rows


def reports(pfb_rows: list, comp_rows: list, ndf: int,
            device: dict) -> dict[str, dict]:
    """The three reports by file stem, with the JAX artifacts' keys."""
    date = time.strftime("%Y-%m-%d")
    kind = device["kind"]
    common = {"baseline_samples_per_sec": BASE, "ndf": ndf, "date": date,
              "device": device}
    return {
        "PFB": {
            "what": f"PFB channelizer throughput on one {kind}, "
                    "full-geometry streaming blocks drawn on the card, wire "
                    "vs rows layouts: the CUDA spectrometer "
                    "(csrc/pfb.cu, the carry chained between calls) at "
                    "nfft 128-1024, beside torch.fft on the card at nfft "
                    "1024 (the reference's planned cuFFT stage, "
                    "makefile:27 / kernel.cuh:7).",
            "measurements": pfb_rows,
            **common,
            "reproduce": [
                "python -m paf_baseband2power_tpu_torch.tools.spectra_bench",
                "python -m paf_baseband2power_tpu_torch.bench  # matrix"],
        },
        "COMPOSE": {
            "what": f"Composed detection modes on one {kind}, wire vs "
                    "rows layouts, full-geometry streaming blocks, and the "
                    "coarse-channel rows kernels (csrc/power.cu, "
                    "csrc/stokes.cu). Reference contract: kernel.cuh:4-7 "
                    "(planned channelizer) x paf_baseband2power.cu:20 "
                    "(detect-and-average).",
            "measurements": comp_rows,
            **common,
            "reproduce": [
                "python -m paf_baseband2power_tpu_torch.tools.spectra_bench",
                "python -m paf_baseband2power_tpu_torch.bench --pfb 128 "
                "--scrunch 64",
                "python -m paf_baseband2power_tpu_torch.bench --pfb 128 "
                "--stokes --device-layout"],
        },
        "DEVICE_LAYOUT": {
            "what": f"Device-layout capability matrix on one {kind}: rows "
                    "blocks (nseries, ndf, 256) from the capture engine's "
                    "host corner turn go to the card 3-D and every kernel "
                    "reads them as they are; the carry is the int16 tail of "
                    "each series. Wire and rows side by side, every mode.",
            "measurements": {"pfb_streaming": pfb_rows,
                             "composed": comp_rows},
            "host_cost": "not measured here: tools/host_runtime.py "
                         "measures the host's ring and capture, and "
                         "cli/paf_soak.py --device-layout the corner turn "
                         "in the live topology",
            **common,
            "reproduce": [
                "python -m paf_baseband2power_tpu_torch.tools.spectra_bench",
                "python -m paf_baseband2power_tpu_torch.probes.streaming "
                "--nfft 1024"],
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.spectra_bench")
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_NDF} frames per block")
    ap.add_argument("--ndf", type=int, default=None,
                    help="frames per block (default 8192, or the quick "
                    "size)")
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC)
    add_platform(ap)
    args = ap.parse_args(argv)
    device = device_for(ap, args.platform)
    ndf = args.ndf or (QUICK_NDF if args.quick else C.NDF_BLK)
    pfb_rows, comp_rows = measure_all(ndf, args.nchk, device,
                                      log=lambda s: print(s, flush=True))
    for stem, report in reports(pfb_rows, comp_rows, ndf,
                                card(device)).items():
        with open(f"{stem}_{args.platform}.json", "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
