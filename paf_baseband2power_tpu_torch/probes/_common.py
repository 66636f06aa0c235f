"""What the probes' entry points share: the device, the timer, the check."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

PARITY_BOUND = 2e-5      # peak-normalized, the JAX sweep's BOUND_PFB


def add_platform(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the CUDA kernels (fails without a GPU); "
                    "cpu: their plain PyTorch versions")


def device_for(ap: argparse.ArgumentParser, platform: str) -> torch.device:
    """The card for ``cuda`` (an argparse error without one: no fallback),
    else the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available "
                 "(--platform cpu runs the plain PyTorch versions)")
    return torch.device("cuda", torch.cuda.current_device())


def describe(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device)}
    return {"platform": "cpu", "kind": "cpu"}


def timer(step, device: torch.device):
    """``run(n)``: seconds for ``n`` calls of ``step``, on the card's clock
    (CUDA events) for a CUDA device, else on the host's."""
    def run(n: int) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            return time.perf_counter() - t0
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            step()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / 1e3

    return run


def slope(run, n1: int, n2: int, repeats: int) -> float:
    """Seconds per call from the two-point slope of ``run(n)``, the best of
    ``repeats`` at ``n1`` and at ``n2`` calls (the JAX probes' timing); the
    mean at ``n2`` when the slope is not positive."""
    t1 = min(run(n1) for _ in range(repeats))
    t2 = min(run(n2) for _ in range(repeats))
    dt = (t2 - t1) / (n2 - n1)
    return t2 / n2 if dt <= 0 else dt


def peak_err(got, want) -> tuple[float, float]:
    """``(max |got - want|, that over max |want|)`` in float64, for tensors
    on one device or arrays."""
    got, want = (t if isinstance(t, torch.Tensor) else
                 torch.from_numpy(np.array(t)) for t in (got, want))
    d = (got.double() - want.double()).abs().max().item()
    return d, d / want.double().abs().max().item()
