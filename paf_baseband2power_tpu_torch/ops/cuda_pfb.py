"""The PFB spectrometer on the card: bindings of ``csrc/pfb.cu``.

Counterpart of ``paf_baseband2power_tpu/ops/pallas_pfb.py``'s entry points
``pfb_spectra_fused`` (K10) and ``pfb_power_fused`` (K9, its ``nout = 1``
power case): one CUDA kernel serves both, for wire and series-row blocks.

Dispatch is by the input's device and nothing else, as in
``ops/cuda_power.py``: a CPU tensor goes to the plain version in
``ops/pfb.py``, a CUDA tensor to the kernel, which either launches or
raises. Launches are counted in ``cuda_power.launches`` by wrapper name,
the float64 partials each call writes in ``partial_bytes``, and the
kernel's launches by the stages of its sample ring that ``pafb2p_pfb``
reports having launched with in ``stage_depths`` (2 where a step's
samples are copied while the step before runs its FFTs, 1 where they
reach shared memory before the step's own), and in ``fft_lane_stages`` by
the cross-lane shuffle stages of its FFTs that it reports (at nfft 256-1024
a transpose in shared memory takes the FFT's lane factor, leaving 2, 1
and 0 stages; at nfft <= 128, log2 of the lanes an FFT spans).

While a torch profiler records, ``_launch``'s steps are spans
(``runtime/trace.py``): ``pafb2p.pfb.carry`` (the previous block's halo
on the card), ``pafb2p.pfb.kernel`` (``pafb2p_pfb``) and
``pafb2p.pfb.finish`` (``pafb2p_pfb_finish``).

The kernel takes the shapes ``kernel_takes`` accepts. ``route`` sends
every other shape to ``pfb_spectra_torch`` / ``pfb_power_torch``: the plain
version on the card through ``torch.fft``, as the JAX package runs the
shapes its fused kernel does not take in XLA. Those runs are counted as
``pfb_torch``. The choice is by ``(nfft, ntap)`` alone, never by a failure:
the CUDA wrappers still raise for a shape the kernel does not take.
``route`` and ``streaming_step`` (the executor's step for a PFB mode) are
the one home of that choice; every caller asks them.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ..constants import NCHAN_CHK, NPOL_SAMP, NSAMP_DF
from ..runtime.trace import span
from . import pfb as PF
from ._build import load_library
from .cuda_power import _on_cpu, _raise, launches

# what the kernel takes; the plain version takes any nfft and ntap >= 1
CUDA_NFFTS = tuple(2 ** i for i in range(1, 11))
CUDA_MAX_NTAP = 8
_TILE_SAMPLES = 8192     # samples per pol in a block's tile, at least
_TILE_WINDOWS = 32       # windows in a block's tile, at least


def tile_slots(nfft: int) -> int:
    """Window end slots per kernel block: ``max(8192 / nfft, 32)``."""
    return max(_TILE_SAMPLES // nfft, _TILE_WINDOWS)


def step_windows(nfft: int) -> int:
    """Windows per step of the kernel (``csrc/pfb.cu``): at least 4, one
    FFT per warp and pol, and at least 1024 samples per pol."""
    return max(4, 1024 // nfft)


def kernel_refuses(nfft: int, ntap: int) -> str | None:
    """Why the CUDA kernel does not take ``(nfft, ntap)``, or None."""
    if nfft not in CUDA_NFFTS:
        if 2 <= nfft <= CUDA_NFFTS[-1]:
            return f"nfft {nfft} is not a power of two"
        return (f"nfft {nfft} is outside the CUDA kernel's "
                f"{CUDA_NFFTS[0]}..{CUDA_NFFTS[-1]}")
    if not 1 <= ntap <= CUDA_MAX_NTAP:
        return f"ntap {ntap} is outside the CUDA kernel's 1..{CUDA_MAX_NTAP}"
    return None


def kernel_takes(nfft: int, ntap: int) -> bool:
    """Whether the CUDA kernel takes ``(nfft, ntap)``: nfft a power of two
    in 2..1024 and 1 <= ntap <= ``CUDA_MAX_NTAP``."""
    return kernel_refuses(nfft, ntap) is None


def _check_kernel_shape(nfft: int, ntap: int) -> None:
    why = kernel_refuses(nfft, ntap)
    if why is not None:
        raise ValueError(f"the CUDA PFB kernel takes nfft in {CUDA_NFFTS} "
                         f"(powers of two 2..1024) and 1 <= ntap <= "
                         f"{CUDA_MAX_NTAP}: {why}")


# (nfft, ntap, window, device) -> float32 coefficients on the card
_coeffs: dict = {}
# float64 bytes of the partials each wrapper's calls wrote, by wrapper name
partial_bytes: collections.Counter = collections.Counter()
# the kernel's launches by stage depth
stage_depths: collections.Counter = collections.Counter()
# the kernel's launches by the cross-lane shuffle stages of their FFTs
fft_lane_stages: collections.Counter = collections.Counter()



def _device_coeffs(nfft: int, ntap: int, window: str,
                   device: torch.device) -> torch.Tensor:
    key = (nfft, ntap, window, device)
    if key not in _coeffs:
        _coeffs[key] = torch.from_numpy(
            PF.pfb_coeffs(nfft, ntap, window, np.float32)).to(device)
    return _coeffs[key]


def _launch(block: torch.Tensor, layout: str, nfft: int, ntap: int,
            window: str, nout: int, stokes: bool, mean: bool, shift: bool,
            history, lib=None) -> tuple[torch.Tensor, int]:
    """Run ``pafb2p_pfb`` and its finish kernel on a CUDA block; returns
    float32 ``(nout, ns, nchan * nfft)`` and the float64 partials' bytes.
    ``lib``: another build of ``csrc/pfb.cu`` with the same C interface
    (``probes/pfb_compare.py``), else the package's. Counts the launch in
    ``stage_depths`` by the depth the kernel reports (0 from an older
    build that takes no depth pointer: the C calling convention leaves the
    extra argument unread), and in ``fft_lane_stages`` by the lane stages
    it reports (not at all from a build that reports none).

    The partials are the call's own, from the caching allocator on the
    current stream, as ``ops/cuda_power.py``'s scratch: two pipelines on
    two streams of one card (beams sharing it) never write each other's,
    and on one stream the allocator hands the same block back once the
    finish that read it is queued."""
    _, ndf, nchk = PF.block_geometry(block, layout)
    _, wpg = PF.spectra_geometry(ndf * NSAMP_DF, nfft, ntap, nout)
    _check_kernel_shape(nfft, ntap)
    if layout == "rows":
        PF.check_rows_nfft(nfft)
    lib = lib or load_library()
    x = (block.reshape(ndf, -1) if layout == "wire"
         else block.reshape(-1, ndf, 2 * NSAMP_DF))
    if x.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    with span("pfb.carry"):
        hist = PF.block_carry(history, ntap, nfft,
                              nchk * NCHAN_CHK * NPOL_SAMP, block.device)
    ts = tile_slots(nfft)
    nsub = -(-wpg // ts)
    ns = 4 if stokes else 1
    nchan = nchk * NCHAN_CHK
    coeffs = _device_coeffs(nfft, ntap, window, block.device)
    partial = torch.empty((nout * nsub, nchan, ns, nfft),
                          dtype=torch.float64, device=block.device)
    out = torch.empty((nout, ns, nchan * nfft), dtype=torch.float32,
                      device=block.device)
    div = (PF.mean_divisors(nout, wpg, ntap, stokes, hist is not None)
           if mean else [0.0])
    stream = torch.cuda.current_stream(block.device).cuda_stream
    depth, lanes = ctypes.c_int(0), ctypes.c_int(-1)
    with torch.cuda.device(block.device):
        with span("pfb.kernel"):
            _raise(lib, lib.pafb2p_pfb(
                x.data_ptr(), int(layout == "rows"), ndf, nchk, nfft, ntap,
                nout, int(stokes), coeffs.data_ptr(),
                hist.data_ptr() if hist is not None else None, ts, nsub,
                partial.data_ptr(), stream, ctypes.byref(depth),
                ctypes.byref(lanes)))
        stage_depths[depth.value] += 1
        if lanes.value >= 0:
            fft_lane_stages[lanes.value] += 1
        with span("pfb.finish"):
            _raise(lib, lib.pafb2p_pfb_finish(
                partial.data_ptr(), out.data_ptr(), nchan, nfft, nout, nsub,
                ns, int(shift), div[0], div[-1] if nout > 1 else 0.0,
                stream))
    return out, partial.numel() * partial.element_size()


def pfb_spectra_cuda(block: torch.Tensor, nfft: int, ntap: int = 4,
                     window: str = "hamming", nout: int = 1,
                     stokes: bool = False, mean: bool = False,
                     shift: bool = True, history=None,
                     return_history: bool = False, layout: str = "wire"):
    """Wire ``(ndf, nchk * 3584)`` or rows ``(nseries, ndf, 256)`` int16
    block -> float32 ``(nout, nchan * nfft)`` or, with ``stokes``,
    ``(nout, 4, nchan * nfft)`` (port of ``pfb_spectra_fused``; the
    contract of ``ops/pfb.py:pfb_spectra``). ``history``: the previous
    block's carry in any format ``pfb.history_from_jax`` takes."""
    if _on_cpu(block):
        return PF.pfb_spectra(block, nfft, ntap, window=window, nout=nout,
                              stokes=stokes, mean=mean, shift=shift,
                              history=history,
                              return_history=return_history, layout=layout)
    out, nbytes = _launch(block, layout, nfft, ntap, window, nout, stokes,
                          mean, shift, history)
    launches["pfb_spectra_cuda"] += 1
    partial_bytes["pfb_spectra_cuda"] += nbytes
    if not stokes:
        out = out[:, 0]
    if return_history:
        return out, PF.pfb_history(block, nfft, ntap, layout)
    return out


def pfb_power_cuda(block: torch.Tensor, nfft: int, ntap: int = 4,
                   window: str = "hamming", mean: bool = False,
                   shift: bool = True, history=None,
                   return_history: bool = False, layout: str = "wire"):
    """Wire or rows int16 block -> float32 ``(nchan * nfft,)`` PFB power
    (port of ``pfb_power_fused``: the same kernel at ``nout = 1``)."""
    if _on_cpu(block):
        return PF.pfb_power(block, nfft, ntap, window=window, mean=mean,
                            shift=shift, history=history,
                            return_history=return_history, layout=layout)
    out, nbytes = _launch(block, layout, nfft, ntap, window, 1, False, mean,
                          shift, history)
    out = out[0, 0]
    launches["pfb_power_cuda"] += 1
    partial_bytes["pfb_power_cuda"] += nbytes
    if return_history:
        return out, PF.pfb_history(block, nfft, ntap, layout)
    return out


def pfb_spectra_torch(block: torch.Tensor, nfft: int, ntap: int = 4, **kw):
    """The plain version of ``pfb_spectra_cuda`` on any device (on the card
    through ``torch.fft``): the route for the shapes the kernel does not
    take. A run on the card counts one ``pfb_torch``."""
    if not _on_cpu(block):
        launches["pfb_torch"] += 1
    return PF.pfb_spectra(block, nfft, ntap, **kw)


def pfb_power_torch(block: torch.Tensor, nfft: int, ntap: int = 4, **kw):
    """The plain version of ``pfb_power_cuda`` on any device; counted as
    ``pfb_spectra_torch`` is."""
    if not _on_cpu(block):
        launches["pfb_torch"] += 1
    return PF.pfb_power(block, nfft, ntap, **kw)


def route(nfft: int, ntap: int):
    """``(power, spectra, label)`` for ``(nfft, ntap)``: the CUDA wrappers
    where the kernel takes the shape (label ``"CUDA kernel"``), else the
    torch.fft route (``"torch.fft: <why>"``); looked up on this module at
    each call."""
    why = kernel_refuses(nfft, ntap)
    if why is None:
        return pfb_power_cuda, pfb_spectra_cuda, "CUDA kernel"
    return pfb_power_torch, pfb_spectra_torch, f"torch.fft: {why}"


def check_layout(nfft: int, ntap: int, layout: str) -> None:
    """Raise ValueError for a series-rows ``(nfft, ntap)`` the kernel's rows
    path does not take (the JAX package's rules and messages)."""
    if layout == "rows":
        PF.check_rows_nfft(nfft)
        PF.check_rows_ntap(ntap)


def streaming_step(nfft: int, ntap: int = 4, window: str = "hamming",
                   nout: int = 1, stokes: bool = False, mean: bool = False,
                   layout: str = "wire"):
    """``(step, label)``: the streaming ``step(x, carry) -> (record,
    carry)`` of a PFB mode on ``route``'s functions (the power one at
    ``nout = 1`` without Stokes, else spectra) and ``route``'s label.
    Raises ValueError for a rows shape ``check_layout`` refuses."""
    check_layout(nfft, ntap, layout)
    power, spectra, label = route(nfft, ntap)
    kw = dict(window=window, mean=mean, layout=layout)
    if nout == 1 and not stokes:
        return PF.make_streaming_pfb(nfft, ntap, power=power, **kw), label
    return PF.make_streaming_spectra(nfft, ntap, nout=nout, stokes=stokes,
                                     spectra=spectra, **kw), label
