"""Probe: a 3-real-product (Karatsuba) 128-point DFT on planar re/im rows.

Counterpart of the JAX package's ``benchmarks/probe_karatsuba.py``, whose
TPU kernel (K13, the closure ``run_planar`` in its ``main``) is ported to
CUDA in ``csrc/probe_karatsuba.cu``.

Planar rows ``(S, ndf, 256)`` int16 hold one 128-sample window per row,
lanes 0-127 re and 128-255 im. Each window is the 4-tap hamming FIR across
rows (``cv = [c, c]``), the first 3 windows of a series masked;
with ``C + iD = exp(-2 pi i n k / 128)`` the DFT takes three real products,

    T = (A + B) C,   RE = T - B (C + D),   IM = T - A (C - D),

and ``|y|^2`` summed over windows gives ``(S, 128)`` float32 in natural
order, not fftshifted. The ``*_cuda`` wrapper takes the plain version for a
CPU tensor and the kernel for a CUDA tensor, counting launches in
``ops/cuda_power.launches``.

    python -m paf_baseband2power_tpu_torch.probes.karatsuba \\
        [--iters 6 --ndf 8192] [--check] [--platform cpu]

prints one JSON object: ms per block of the kernel at R = 1024 and 2048
windows per tile and of the production spectrometer on the same rows
(``pfb_spectra_cuda(rows, 128, 4, layout="rows")``), CUDA events and the
JAX probe's two-point slope; or, with ``--check``, the error against a
float64 numpy golden at 4 series x 64 windows. Data is int16 in
[-256, 256), drawn on the device from seed 0 (``--check``: numpy's
``default_rng(0)``, as in the JAX probe).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import cuda_pfb as CF
from ..ops.pfb import pfb_coeffs
from ..ops._build import load_library
from ..ops.cuda_power import _on_cpu, _raise, launches
from . import _common

L = 128
NTAP = 4
NSERIES = 48 * 14
SERIES_GROUP = 48       # series per step of the plain version (bounds memory)


def planar_ops(dtype=np.float32) -> tuple[np.ndarray, ...]:
    """``(cv (NTAP, 256), C, C + D, C - D (128, 128) [n][k])`` in
    ``dtype``, from float64 (the JAX probe's ``planar_ops``)."""
    c = pfb_coeffs(L, NTAP, "hamming", dtype=np.float64)
    return (np.concatenate([c, c], axis=1).astype(dtype),
            *_common.dft_matrices(dtype))


def _geometry(rows: torch.Tensor, R: int) -> tuple[int, int]:
    if rows.ndim != 3 or rows.shape[2] != 2 * L:
        raise ValueError(f"planar rows are (S, ndf, {2 * L}), got "
                         f"{tuple(rows.shape)}")
    S, ndf, _ = rows.shape
    if R < 1 or ndf % R:
        raise ValueError(f"R={R} must divide ndf={ndf}")
    return S, ndf


def karatsuba_planar(rows: torch.Tensor, R: int = 1024,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K13: planar rows ``(S, ndf, 256)`` int16 -> float32
    ``(S, 128)``. The three products are ``torch.matmul`` in ``dtype``
    (float32, or float64 as the on-card reference), with TF32 off on the
    card. ``R`` only has to divide ``ndf``, as for the kernel."""
    S, ndf = _geometry(rows, R)
    dev = rows.device
    cv, c1, c2, c3 = (torch.from_numpy(m).to(dev, dtype) for m in
                      planar_ops(np.float64))
    nwin = ndf - (NTAP - 1)
    out = torch.zeros((S, L), dtype=dtype, device=dev)
    if nwin <= 0:
        return out.to(torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s0 in range(0, S, SERIES_GROUP):
            x = rows[s0:s0 + SERIES_GROUP].to(dtype)
            z = cv[0] * x[:, :nwin]
            for k in range(1, NTAP):
                z = z + cv[k] * x[:, k:k + nwin]
            del x
            a, b = z[..., :L], z[..., L:]
            t = (a + b) @ c1
            re = t - b @ c2
            im = t - a @ c3
            del z, t
            out[s0:s0 + SERIES_GROUP] = (re.square() + im.square()).sum(dim=1)
            del re, im
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.to(torch.float32)


def karatsuba_planar_cuda(rows: torch.Tensor, R: int = 1024,
                          lib=None) -> torch.Tensor:
    """K13 (``csrc/probe_karatsuba.cu``) for a CUDA tensor, the plain version
    (float32) for a CPU one. ``lib``: another build of the kernels
    (``probes/probe_compare.py``), else the package's."""
    S, ndf = _geometry(rows, R)
    if _on_cpu(rows):
        return karatsuba_planar(rows, R)
    other, lib = lib is not None, lib or load_library()
    if rows.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    cv, *dft = planar_ops()
    cv = torch.from_numpy(cv).to(rows.device)
    # the package's kernel forms the DFT itself and ignores c1..c3; another
    # build (an older one, probes/probe_compare.py) may read them
    dft = [torch.from_numpy(m).to(rows.device) for m in dft] if other else []
    mats = [m.data_ptr() for m in dft] or [None] * 3
    ntiles = ndf // R
    partial = torch.empty((S, ntiles, L), dtype=torch.float64,
                          device=rows.device)
    out = torch.empty((S, L), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        _raise(lib, lib.pafb2p_probe_karatsuba(
            rows.data_ptr(), S, ndf, NTAP, R, cv.data_ptr(), *mats,
            partial.data_ptr(), stream))
        _raise(lib, lib.pafb2p_probe_tile_sum(
            partial.data_ptr(), out.data_ptr(), S, ntiles, L, stream))
    launches["karatsuba_planar_cuda"] += 1
    return out


def karatsuba_planar_split(rows: torch.Tensor,
                           split: str = _common.KERNEL_SPLIT) -> np.ndarray:
    """The kernel's arithmetic emulated on the CPU, float64 ``(S, 128)``:
    the FIR in float32, then the three products under ``split``
    (``_common.split_dft_power``)."""
    S, ndf = _geometry(rows, 1)
    cv, c1, c2, c3 = planar_ops()
    x = rows.cpu().numpy().astype(np.float32)
    nwin = ndf - (NTAP - 1)
    out = np.zeros((S, L))
    for s0 in range(0, S, SERIES_GROUP):
        xs = x[s0:s0 + SERIES_GROUP]
        z = cv[0] * xs[:, :nwin]
        for k in range(1, NTAP):
            z = z + cv[k] * xs[:, k:k + nwin]
        out[s0:s0 + SERIES_GROUP] = _common.split_dft_power(
            z[..., :L], z[..., L:], c1, c2, c3, split).sum(axis=1)
    return out


def planar_golden(rows: np.ndarray) -> np.ndarray:
    """float64 numpy golden of K13 on planar rows ``(S, ndf, 256)`` (the
    JAX probe's ``--check``): FIR over whole windows, ``|fft|^2`` summed."""
    S, ndf, _ = rows.shape
    v = (rows[:, :, :L].astype(np.float64)
         + 1j * rows[:, :, L:].astype(np.float64))
    c = pfb_coeffs(L, NTAP, "hamming", dtype=np.float64)
    nwin = ndf - (NTAP - 1)
    z = sum(c[t] * v[:, t:t + nwin] for t in range(NTAP))
    return (np.abs(np.fft.fft(z, axis=-1)) ** 2).sum(axis=1)


def check_rows() -> np.ndarray:
    """The ``--check`` input: 4 series x 64 windows, ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return rng.integers(-256, 256, (4, 64, 2 * L)).astype(np.int16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="probe_karatsuba",
        description="time a 3-real-product DFT spectrometer on planar rows "
        "(CUDA kernel of the JAX probe's K13)")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--ndf", type=int, default=8192)
    ap.add_argument("--check", action="store_true",
                    help="verify numerics vs a numpy golden at tiny size")
    _common.add_platform(ap)
    args = ap.parse_args(argv)
    device = _common.device_for(ap, args.platform)

    if args.check:
        rows = check_rows()
        got = karatsuba_planar_cuda(torch.from_numpy(rows).to(device),
                                    R=rows.shape[1])
        err = _common.peak_err(got.cpu(), planar_golden(rows))[1]
        print(json.dumps({"check_err": err}))
        return 0

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = torch.randint(-256, 256, (NSERIES, args.ndf, 2 * L),
                         dtype=torch.int16, device=device, generator=gen)

    def slope(step) -> float:
        """The JAX probe's timing: ``n``, then ``3 n`` calls, best of 3."""
        step()
        n = max(2, args.iters // 3)
        return _common.slope(_common.timer(step, device), n, 3 * n, 3)

    results = {}
    for R in (1024, 2048):
        if args.ndf % R:
            continue
        results[f"karatsuba R={R}"] = round(slope(
            lambda R=R: karatsuba_planar_cuda(rows, R)) * 1e3, 2)
    results["interleaved production"] = round(slope(
        lambda: CF.pfb_spectra_cuda(rows, 128, NTAP, layout="rows")) * 1e3, 2)
    print(json.dumps({"ndf": args.ndf, "device": _common.describe(device),
                      "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
