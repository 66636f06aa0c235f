"""What the entry points share (the probes, the bench, ``parity`` and the
tools): the device and its description, blocks drawn on it, the timer, the
check."""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .. import constants as C
from ..ops import power as P

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


def card(device: torch.device) -> dict:
    """The device a line was measured on; for a card, also ``nvidia-smi``'s
    name and power limit."""
    out = describe(device)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
        out["nvidia_smi"] = "; ".join(smi.strip().splitlines())
    return out


def make_block_2d(ndf: int, device: torch.device, seed: int = 0,
                  nchk: int = C.NCHK_NIC) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584)`` int16 in [-256, 256), drawn on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-256, 256, (ndf, nchk * P.LANES_PER_CHUNK),
                         dtype=torch.int16, device=device, generator=gen)


def make_block_rows(ndf: int, device: torch.device, seed: int = 0,
                    nchk: int = C.NCHK_NIC) -> torch.Tensor:
    """Series rows ``(nchk * 14, ndf, 256)`` int16 in [-256, 256), as the
    capture engine's device-layout mode delivers them, drawn on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nseries = nchk * C.NCHAN_CHK * C.NPOL_SAMP
    return torch.randint(-256, 256, (nseries, ndf, P.ROW_LANES),
                         dtype=torch.int16, device=device, generator=gen)


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


# --- the tensor-core DFT's arithmetic (csrc/tc_dft.cuh), emulated ----------

KERNEL_SPLIT = "3xbf16"      # the split csrc/tc_dft.cuh runs


def dft_matrices(dtype=np.float32) -> tuple[np.ndarray, ...]:
    """``(C, C + D, C - D)``, ``(128, 128)`` ``[n][k]`` in ``dtype`` from
    float64, with ``C + iD = exp(-2 pi i n k / 128)``: the three matrices of
    the tensor-core DFT."""
    w = np.exp(-2j * np.pi * np.outer(np.arange(128), np.arange(128)) / 128)
    cm, dm = w.real, w.imag
    return tuple(m.astype(dtype) for m in (cm, cm + dm, cm - dm))


def round_tf32(x) -> np.ndarray:
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` does: 10 stored mantissa
    bits, round to nearest, ties away from zero (kept as float32)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def round_bf16(x) -> np.ndarray:
    """float32 -> bfloat16, round to nearest even (kept as float32)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def split_matmul(x, m, split: str = KERNEL_SPLIT) -> np.ndarray:
    """``x @ m`` of float32 operands as the tensor cores form it under
    ``split``, in float64: ``3xbf16`` (the kernels' and the JAX probes':
    ``hi = bf16(v)``, ``lo = bf16(v - hi)`` of each operand, ``hi lo + lo
    hi + hi hi``), ``3xtf32`` (the same in TF32, ``cvt.rna``) or ``tf32``
    (``hi hi`` alone)."""
    rnd = round_bf16 if split == "3xbf16" else round_tf32
    parts = []
    for v in (np.asarray(x, np.float32), np.asarray(m, np.float32)):
        hi = rnd(v)
        parts.append((hi.astype(np.float64),
                      rnd(v - hi).astype(np.float64)))
    (xh, xl), (mh, ml) = parts
    if split == "tf32":
        return xh @ mh
    return xh @ ml + xl @ mh + xh @ mh


def split_dft_power(re, im, c1, c2, c3,
                    split: str = KERNEL_SPLIT) -> np.ndarray:
    """``|y|^2`` in float64 of the 128-point DFT of float32 rows ``re + i
    im`` (``(..., 128)``) through the three products of
    ``csrc/tc_dft.cuh``, ``T = (re + im) c1``, ``RE = T - im c2``, ``IM = T
    - re c3``, each formed as :func:`split_matmul`."""
    re, im = np.asarray(re, np.float32), np.asarray(im, np.float32)
    t = split_matmul(re + im, c1, split)
    y_re = t - split_matmul(im, c2, split)
    y_im = t - split_matmul(re, c3, split)
    return y_re * y_re + y_im * y_im
