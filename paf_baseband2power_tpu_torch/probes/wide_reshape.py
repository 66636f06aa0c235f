"""Probe: what does the spectrometer's narrow -> wide window regroup cost,
and what does the stage-A DFT across a window's 128-sample chunks cost?

Counterpart of the JAX package's ``benchmarks/probe_wide_reshape.py``, with
its two TPU kernels ported to CUDA (``csrc/probe_micro.cu``,
``csrc/probe_planes.cu``):

1. MICRO (K11): the column sums of series rows, read as ``R * n1`` narrow
   rows or as ``R`` wide rows of ``n1 * 256`` lanes. The TPU kernel assigns
   its resident output block on every tile, so its result is the sums of the
   LAST ``R * n1``-row tile of each series, though it reads them all; the
   port returns the same function and its kernel reads every tile too.
2. PLANES (K12): a one-shot power spectrometer on the "planes" layout
   ``(nseries, n1, nrow, 256)``, plane ``m`` holding chunk ``m`` of every
   window, so nothing is widened: hamming FIR per plane, the first
   ``ntap - 1`` windows masked, an ``n1 x 128`` four-step DFT and ``|y|^2``
   summed over windows -> ``(nseries, nfft)``, lane ``k1 * 128 + k2``
   holding fine channel ``n1 * k2 + k1`` (not fftshifted, pols not folded).
   ``stage_a`` picks the probe's ablations: ``full``; ``fft8`` (the same
   function through a radix-2^3 DIF, ``n1 = 8`` only); ``noswap`` (the real
   part of the stage-A twiddles only) and ``none`` (chunk 0 for every k1),
   both wrong by design and deterministic.

Each kernel has its plain PyTorch version beside it; the ``*_cuda``
wrappers take the plain version for a CPU tensor and the kernel for a CUDA
tensor, counting launches in ``ops/cuda_power.launches``.

    python -m paf_baseband2power_tpu_torch.probes.wide_reshape \\
        [--nfft 1024 --ndf 8192 --nchk 48 --iters 12] [--platform cpu]

prints one JSON object: ms per block of the production spectrometer
(``pfb_spectra_cuda(rows, nfft, 4, layout="rows")``), of micro narrow and
widen and of each planes variant (CUDA events, the two-point slope of the
JAX probe), and the planes kernel's error against the port's float64 PFB
at a reduced geometry. Data is int16 in [-256, 256) drawn on the device
from seed 0.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import cuda_pfb as CF
from ..ops import pfb as PF
from ..ops._build import load_library
from ..ops.cuda_power import _on_cpu, _raise, launches
from ..ops.frame import block_to_rows, synthetic_block
from . import _common

L = 128                                   # samples per chunk / plane row
STAGE_A = ("full", "fft8", "noswap", "none")
PLANES_N1 = (1, 2, 4, 8)                  # nfft 128 .. 1024
SERIES_GROUP = 48       # series per step of the plain version (bounds memory)


# ---------------------------------------------------------------------------
# 1. MICRO (K11)
# ---------------------------------------------------------------------------

def _micro_geometry(rows: torch.Tensor, n1: int, R: int) -> tuple[int, int]:
    """``(nseries, ndf)`` of series rows ``(nseries, ndf, 256)`` cut into
    tiles of ``R * n1`` rows."""
    if rows.ndim != 3 or rows.shape[2] != 2 * L:
        raise ValueError(f"micro takes rows (nseries, ndf, {2 * L}), got "
                         f"{tuple(rows.shape)}")
    nseries, ndf, _ = rows.shape
    if n1 < 1 or R < 1 or ndf % (R * n1):
        raise ValueError(f"tiles of R * n1 = {R} * {n1} rows must divide "
                         f"ndf={ndf}")
    return nseries, ndf


def micro(rows: torch.Tensor, n1: int, R: int,
          widen: bool = False) -> torch.Tensor:
    """Plain version of K11: float32 ``(nseries, 1, 256)``, the column sums
    of each series' last ``R * n1``-row tile (exact int64, one rounding).
    ``widen`` folds ``R`` wide rows of ``n1 * 256`` lanes instead; the
    numbers are the same."""
    nseries, ndf = _micro_geometry(rows, n1, R)
    last = rows[:, ndf - R * n1:].to(torch.int64)
    if widen:
        s = last.reshape(nseries, R, n1 * 2 * L).sum(dim=1)
        s = s.reshape(nseries, n1, 2 * L).sum(dim=1)
    else:
        s = last.sum(dim=1)
    return s.to(torch.float32).reshape(nseries, 1, 2 * L)


def micro_cuda(rows: torch.Tensor, n1: int, R: int,
               widen: bool = False) -> torch.Tensor:
    """K11 (``csrc/probe_micro.cu``) for a CUDA tensor, the plain version
    for a CPU one. The kernel reads every tile into a ``(nseries, ntiles,
    256)`` partials array; the result is a view of its last tile."""
    nseries, ndf = _micro_geometry(rows, n1, R)
    if _on_cpu(rows):
        return micro(rows, n1, R, widen)
    lib = load_library()
    if rows.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    partial = torch.empty((nseries, ndf // (R * n1), 2 * L),
                          dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        _raise(lib, lib.pafb2p_probe_micro(rows.data_ptr(), nseries, ndf, n1,
                                           R, int(widen), partial.data_ptr(),
                                           stream))
    launches["micro_cuda"] += 1
    return partial[:, -1:]


# ---------------------------------------------------------------------------
# 2. PLANES (K12)
# ---------------------------------------------------------------------------

def to_planes(rows: torch.Tensor, n1: int) -> torch.Tensor:
    """Series rows ``(nseries, ndf, 256)`` -> planes ``(nseries, n1, ndf /
    n1, 256)`` on the same device (a copy): plane ``m`` row ``w`` is row
    ``w * n1 + m``."""
    nseries, ndf, lanes = rows.shape
    return (rows.reshape(nseries, ndf // n1, n1, lanes).transpose(1, 2)
            .contiguous())


def bins_in_order(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """Planes output lanes ``k1 * 128 + k2`` -> natural fine channels."""
    n1 = nfft // L
    shape = spec.shape
    return spec.reshape(-1, n1, L).transpose(1, 2).reshape(shape)


def _planes_geometry(xp: torch.Tensor, nfft: int, ntap: int, R: int,
                     stage_a: str) -> tuple[int, int, int]:
    """Validate planes for one call; returns ``(nseries, n1, nrow)``."""
    n1 = nfft // L
    if nfft % L or n1 not in PLANES_N1:
        sizes = tuple(L * n for n in PLANES_N1)
        raise ValueError(f"planes take nfft in {sizes}, got {nfft}")
    if xp.ndim != 4 or xp.shape[1] != n1 or xp.shape[3] != 2 * L:
        raise ValueError(f"planes for nfft {nfft} are (nseries, {n1}, nrow, "
                         f"{2 * L}), got {tuple(xp.shape)}")
    nseries, _, nrow, _ = xp.shape
    if R < 1 or nrow % R:
        raise ValueError(f"R={R} must divide the {nrow} windows per series")
    if ntap < 1:
        raise ValueError(f"ntap={ntap} must be >= 1")
    if stage_a not in STAGE_A:
        raise ValueError(f"stage_a must be one of {STAGE_A}, got "
                         f"'{stage_a}'")
    if stage_a == "fft8" and n1 != 8:
        raise ValueError(f"stage_a=fft8 is the 8-point stage A of nfft "
                         f"1024, got nfft {nfft}")
    return nseries, n1, nrow


def _stage_a_matrix(n1: int, stage_a: str) -> np.ndarray:
    """``(k1, m)`` complex weights of stage A: ``W_n1^(m k1)`` (full,
    fft8), their real part (noswap), or chunk 0 alone (none)."""
    k1 = np.arange(n1)
    w = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)
    if stage_a == "noswap":
        return w.real.astype(np.complex128)
    if stage_a == "none":
        w = np.zeros((n1, n1), np.complex128)
        w[:, 0] = 1.0
    return w


def _twiddled(xp: torch.Tensor, nfft: int, ntap: int, stage_a: str,
              dtype: torch.dtype):
    """Yield ``(s0, y)`` for each group of series from ``s0``: the FIR of
    every plane, stage A and the twiddle ``W_N^(n2 k1)`` in ``dtype``'s
    complex type, ``y`` ``(group, n1, nwin, 128)``, ready for the 128-point
    DFT over its last axis."""
    nseries, n1, nrow, _ = xp.shape
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    dev = xp.device
    c = torch.from_numpy(PF.pfb_coeffs(nfft, ntap, "hamming", np.float64)
                         ).to(dev, dtype).reshape(ntap, n1, 1, L)
    a_mat = torch.from_numpy(_stage_a_matrix(n1, stage_a)).to(dev, ctype)
    k1n2 = np.outer(np.arange(n1), np.arange(L))
    tw = torch.from_numpy(np.exp(-2j * np.pi * k1n2 / nfft)
                          ).to(dev, ctype).reshape(n1, 1, L)
    nwin = nrow - (ntap - 1)
    for s0 in range(0, nseries, SERIES_GROUP):
        v = torch.view_as_complex(
            xp[s0:s0 + SERIES_GROUP].to(dtype)
            .reshape(-1, n1, nrow, L, 2).contiguous())
        z = c[0] * v[:, :, :nwin]
        for k in range(1, ntap):
            z = z + c[k] * v[:, :, k:k + nwin]
        del v
        yield s0, torch.einsum("km,smwn->skwn", a_mat, z) * tw


def planes(xp: torch.Tensor, nfft: int, ntap: int = 4, R: int = 8,
           stage_a: str = "full",
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K12: planes ``(nseries, n1, nrow, 256)`` int16 ->
    float32 ``(nseries, nfft)``, hamming FIR of ``ntap`` taps. ``dtype``:
    the arithmetic, float32 or float64 (the on-card reference). ``R`` only
    has to divide ``nrow``, as for the kernel: the sums do not depend on
    it."""
    nseries, n1, nrow = _planes_geometry(xp, nfft, ntap, R, stage_a)
    out = torch.zeros((nseries, n1, L), dtype=dtype, device=xp.device)
    if nrow - (ntap - 1) <= 0:
        return out.reshape(nseries, nfft).to(torch.float32)
    for s0, y in _twiddled(xp, nfft, ntap, stage_a, dtype):
        y = torch.fft.fft(y, dim=-1)
        out[s0:s0 + SERIES_GROUP] = (y.real.square()
                                     + y.imag.square()).sum(dim=2)
        del y
    return out.reshape(nseries, nfft).to(torch.float32)


def planes_split(xp: torch.Tensor, nfft: int, ntap: int = 4,
                 stage_a: str = "full",
                 split: str = _common.KERNEL_SPLIT) -> np.ndarray:
    """The kernel's arithmetic emulated on the CPU, float64 ``(nseries,
    nfft)``: FIR, stage A and twiddle in float32, then the 128-point DFT as
    ``csrc/tc_dft.cuh``'s three products under ``split``
    (``_common.split_dft_power``)."""
    nseries, n1, nrow = _planes_geometry(xp, nfft, ntap, 1, stage_a)
    c1, c2, c3 = _common.dft_matrices()
    out = np.zeros((nseries, n1, L))
    for s0, y in _twiddled(xp.cpu(), nfft, ntap, stage_a, torch.float32):
        out[s0:s0 + SERIES_GROUP] = _common.split_dft_power(
            y.real.numpy(), y.imag.numpy(), c1, c2, c3, split).sum(axis=2)
    return out.reshape(nseries, nfft)


def planes_cuda(xp: torch.Tensor, nfft: int, ntap: int = 4, R: int = 8,
                stage_a: str = "full", lib=None) -> torch.Tensor:
    """K12 (``csrc/probe_planes.cu``) for a CUDA tensor, the plain version
    (float32) for a CPU one. The kernel takes ``1 <= ntap <= 8``. ``lib``:
    another build of the kernels (``probes/probe_compare.py``), else the
    package's."""
    nseries, n1, nrow = _planes_geometry(xp, nfft, ntap, R, stage_a)
    if _on_cpu(xp):
        return planes(xp, nfft, ntap, R, stage_a)
    if ntap > 8:
        raise ValueError(f"the CUDA planes kernel takes ntap <= 8, got "
                         f"{ntap}")
    lib = lib or load_library()
    if xp.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    coeffs = torch.from_numpy(PF.pfb_coeffs(nfft, ntap, "hamming",
                                            np.float32)).to(xp.device)
    ntiles = nrow // R
    partial = torch.empty((nseries, ntiles, nfft), dtype=torch.float64,
                          device=xp.device)
    out = torch.empty((nseries, nfft), dtype=torch.float32, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    with torch.cuda.device(xp.device):
        _raise(lib, lib.pafb2p_probe_planes(
            xp.data_ptr(), nseries, n1, nrow, ntap, R,
            STAGE_A.index(stage_a), coeffs.data_ptr(), partial.data_ptr(),
            stream))
        _raise(lib, lib.pafb2p_probe_tile_sum(
            partial.data_ptr(), out.data_ptr(), nseries, ntiles, nfft,
            stream))
    launches["planes_cuda"] += 1
    return out


def planes_parity(nfft: int, stage_a: str, device: torch.device) -> float:
    """Peak-normalized error of ``planes_cuda`` (the plain version on the
    CPU) against the port's float64 PFB on ``synthetic_block(rng=7, ndf=64,
    nchk=2)``, lanes put in order and pols folded (the JAX probe's check)."""
    n1 = nfft // L
    blk = synthetic_block(rng=7, ndf=64, nchk=2)
    rows = torch.from_numpy(block_to_rows(blk)).to(device)
    want = PF.pfb_power(torch.from_numpy(blk.reshape(64, -1)).to(device),
                        nfft, 4, shift=False, dtype=torch.float64)
    got = planes_cuda(to_planes(rows, n1), nfft, 4, max(8, 64 // n1 // 2),
                      stage_a)
    got = bins_in_order(got, nfft).reshape(2 * 7, 2, nfft).sum(dim=1)
    return _common.peak_err(got, want.reshape(2 * 7, nfft))[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="probe_wide_reshape",
        description="time the spectrometer's narrow/wide reshape and its "
        "planes layout (CUDA kernels of the JAX probe's K11-K12)")
    ap.add_argument("--nfft", type=int, default=1024)
    ap.add_argument("--ndf", type=int, default=8192)
    ap.add_argument("--nchk", type=int, default=48)
    ap.add_argument("--iters", type=int, default=12)
    _common.add_platform(ap)
    args = ap.parse_args(argv)
    device = _common.device_for(ap, args.platform)

    n1 = args.nfft // L
    nseries = args.nchk * 14
    nrow = args.ndf // n1
    report = {"nfft": args.nfft, "ndf": args.ndf, "nchk": args.nchk,
              "device": _common.describe(device), "results": {}}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = torch.randint(-256, 256, (nseries, args.ndf, 2 * L),
                         dtype=torch.int16, device=device, generator=gen)

    def time_step(step) -> float:
        """The JAX probe's timing: iters / 3, then iters calls, best of 4."""
        step()
        return _common.slope(_common.timer(step, device),
                             max(2, args.iters // 3), args.iters, 4)

    # 0. production baseline
    report["results"]["production rows"] = round(time_step(
        lambda: CF.pfb_spectra_cuda(rows, args.nfft, 4, layout="rows"))
        * 1e3, 2)

    # 1. micro: narrow vs widened reduce at the production tile shape
    # (capped at the windows of a series, for small test blocks)
    R = min(max(8, 1024 // n1), nrow)
    for widen in (False, True):
        label = f"micro {'widen' if widen else 'narrow'}"
        report["results"][label] = round(time_step(
            lambda w=widen: micro_cuda(rows, n1, R, w)) * 1e3, 2)

    # 2. planes layout, made on the device (a one-time cost, excluded: the
    # capture corner turn would emit it directly)
    xp = to_planes(rows, n1)
    for sa in STAGE_A:
        if nrow % R:
            continue
        label = f"planes R={R} stage_a={sa}"
        try:
            report["results"][label] = round(time_step(
                lambda sa=sa: planes_cuda(xp, args.nfft, 4, R, sa)) * 1e3, 2)
        except ValueError as e:
            report["results"][label] = f"{type(e).__name__}: {str(e)[:120]}"
    del rows, xp

    # numerical check against the float64 PFB at a reduced geometry
    for sa in ("full", "fft8"):
        if sa == "fft8" and n1 != 8:
            continue
        err = planes_parity(args.nfft, sa, device)
        report[f"parity_err_{sa}"] = err
        report[f"parity_ok_{sa}"] = err < _common.PARITY_BOUND
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
