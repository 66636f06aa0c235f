"""The PFB spectrometer on the card: bindings of ``csrc/pfb.cu``.

Counterpart of ``paf_baseband2power_tpu/ops/pallas_pfb.py``'s entry points
``pfb_spectra_fused`` (K10) and ``pfb_power_fused`` (K9, its ``nout = 1``
power case): one CUDA kernel serves both, for wire and series-row blocks.

Dispatch is by the input's device and nothing else, as in
``ops/cuda_power.py``: a CPU tensor goes to the plain version in
``ops/pfb.py``, a CUDA tensor to the kernel, which either launches or
raises. Launches are counted in ``cuda_power.launches`` by wrapper name.
"""

from __future__ import annotations

import numpy as np
import torch

from paf_baseband2power_tpu.constants import NCHAN_CHK, NPOL_SAMP, NSAMP_DF

from . import pfb as PF
from ._build import load_library
from .cuda_power import _on_cpu, _raise, launches

# what the kernel takes; the plain version takes any nfft and ntap >= 1
CUDA_NFFTS = tuple(2 ** i for i in range(1, 11))
CUDA_MAX_NTAP = 8
_MIN_STEP = 256          # samples per pol per kernel step (csrc/pfb.cu)
_STEPS_PER_TILE = 32     # steps per block: the tile of window end slots


def tile_slots(nfft: int) -> int:
    """Window end slots per kernel block: 32 steps of
    ``max(256 / nfft, 1)`` windows."""
    return _STEPS_PER_TILE * max(_MIN_STEP // nfft, 1)


def _check_kernel_shape(nfft: int, ntap: int) -> None:
    if nfft not in CUDA_NFFTS:
        raise ValueError(f"the CUDA PFB kernel takes nfft in {CUDA_NFFTS} "
                         f"(powers of two 2..1024), got {nfft}")
    if not 1 <= ntap <= CUDA_MAX_NTAP:
        raise ValueError(f"the CUDA PFB kernel takes 1 <= ntap <= "
                         f"{CUDA_MAX_NTAP}, got {ntap}")


def _launch(block: torch.Tensor, layout: str, nfft: int, ntap: int,
            window: str, nout: int, stokes: bool, mean: bool, shift: bool,
            history) -> torch.Tensor:
    """Run ``pafb2p_pfb`` and its finish kernel on a CUDA block; returns
    float32 ``(nout, ns, nchan * nfft)``."""
    _, ndf, nchk = PF.block_geometry(block, layout)
    _, wpg = PF.spectra_geometry(ndf * NSAMP_DF, nfft, ntap, nout)
    _check_kernel_shape(nfft, ntap)
    lib = load_library()
    x = (block.reshape(ndf, -1) if layout == "wire"
         else block.reshape(-1, ndf, 2 * NSAMP_DF))
    if x.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    hist = PF.block_carry(history, ntap, nfft,
                          nchk * NCHAN_CHK * NPOL_SAMP, block.device)
    ts = tile_slots(nfft)
    nsub = -(-wpg // ts)
    ns = 4 if stokes else 1
    nchan = nchk * NCHAN_CHK
    coeffs = torch.from_numpy(PF.pfb_coeffs(nfft, ntap, window, np.float32)
                              ).to(block.device)
    partial = torch.empty((nout * nsub, nchan, ns, nfft), dtype=torch.float64,
                          device=block.device)
    out = torch.empty((nout, ns, nchan * nfft), dtype=torch.float32,
                      device=block.device)
    div = (PF.mean_divisors(nout, wpg, ntap, stokes, hist is not None)
           if mean else [0.0])
    stream = torch.cuda.current_stream(block.device).cuda_stream
    with torch.cuda.device(block.device):
        _raise(lib, lib.pafb2p_pfb(
            x.data_ptr(), int(layout == "rows"), ndf, nchk, nfft, ntap, nout,
            int(stokes), coeffs.data_ptr(),
            hist.data_ptr() if hist is not None else None, ts, nsub,
            partial.data_ptr(), stream))
        _raise(lib, lib.pafb2p_pfb_finish(
            partial.data_ptr(), out.data_ptr(), nchan, nfft, nout, nsub, ns,
            int(shift), div[0], div[-1] if nout > 1 else 0.0, stream))
    return out


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
    out = _launch(block, layout, nfft, ntap, window, nout, stokes, mean,
                  shift, history)
    launches["pfb_spectra_cuda"] += 1
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
    out = _launch(block, layout, nfft, ntap, window, 1, False, mean, shift,
                  history)[0, 0]
    launches["pfb_power_cuda"] += 1
    if return_history:
        return out, PF.pfb_history(block, nfft, ntap, layout)
    return out
