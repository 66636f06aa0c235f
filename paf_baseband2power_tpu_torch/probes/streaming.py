"""Probe: the cost of the overlap-save carry in the streaming rows PFB.

The counterpart of the JAX package's ``benchmarks/probe_streaming.py``,
on the port's CUDA spectrometer (``ops/cuda_pfb.py:pfb_spectra_cuda``,
``layout="rows"``) and one series-rows block ``(672, ndf, 256)`` drawn on
the card. Five steps separate what a stream adds to one call:

  A  one-shot kernel
  B  one-shot + return_history            (+ the tail copied out)
  C  history input, fixed h               (+ the carry taken in)
  D  history + return_history, fixed h    (both, no dependency between calls)
  E  chained streaming (h from prev call) (the streaming programs' step)

On the port the carry is the int16 tail of each series
(``ops/pfb.py:pfb_history``, a copy of its own) and goes into the kernel
as it is (``pfb.block_carry``), so B - A and C - A are the cost of that
copy and of the check, and E - D that of the dependency. Each step's time
is the two-point slope on the card's clock (CUDA events; the host's clock
on the CPU) at ``--iters`` and three times as many calls, the best of 3,
after one warm-up call, as the JAX script times it; a step that launched
no kernel on the card is an error.

    python -m paf_baseband2power_tpu_torch.probes.streaming [--nfft 128]
        [--iters 8] [--ndf 8192] [--platform {cuda,cpu}]

Prints the JAX script's one line: ``{"nfft", "ndf", "ms": {step: ms}}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import cuda_pfb as CF
from ..ops import cuda_power as CP
from ._common import add_platform, device_for, make_block_rows, slope, timer

NTAP = 4
LABELS = ("A one-shot", "B +return_history", "C +history-in (fixed)",
          "D both (fixed h)", "E chained streaming")


def make_steps(rows: torch.Tensor, nfft: int) -> dict:
    """The five steps on ``rows``, by label: each ``step() -> output``
    (B and D return ``(spectra, carry)``); E carries its own state, which
    starts at the block's own tail ``h0``, as C and D use."""
    def run(**kw):
        return CF.pfb_spectra_cuda(rows, nfft, NTAP, layout="rows", **kw)

    _, h0 = run(return_history=True)
    state = {"h": h0}

    def e_step():
        out, state["h"] = run(history=state["h"], return_history=True)
        return out

    return dict(zip(LABELS, (
        lambda: run(),
        lambda: run(return_history=True),
        lambda: run(history=h0),
        lambda: run(history=h0, return_history=True),
        e_step)))


def time_steps(steps: dict, device: torch.device, iters: int) -> dict:
    """Seconds per call of each step; raises on the card if a step
    launched no ``pfb_spectra_cuda``."""
    results = {}
    for label, step in steps.items():
        step()      # warm
        before = CP.launches["pfb_spectra_cuda"]
        results[label] = slope(timer(step, device), iters, 3 * iters, 3)
        if device.type == "cuda" and \
                CP.launches["pfb_spectra_cuda"] == before:
            raise RuntimeError(f"{label}: pfb_spectra_cuda launched no "
                               f"kernel: {dict(CP.launches)}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.probes.streaming")
    ap.add_argument("--nfft", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--ndf", type=int, default=8192)
    add_platform(ap)
    args = ap.parse_args(argv)
    device = device_for(ap, args.platform)
    rows = make_block_rows(args.ndf, device, seed=0)
    results = time_steps(make_steps(rows, args.nfft), device, args.iters)
    print(json.dumps({
        "nfft": args.nfft, "ndf": args.ndf,
        "ms": {k: v * 1e3 for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
