"""Plain PyTorch PFB spectrometer: polyphase FIR -> FFT -> power or full
Stokes -> waterfall of ``nout`` spectra, with the overlap-save carry.

Counterpart of ``paf_baseband2power_tpu/ops/pfb.py`` (``pfb_power``,
``pfb_spectra``, ``pfb_history``, ``history_as_complex`` and the streaming
factories) with the contract of its float64 golden ``pfb_spectra_golden``:

* the prototype FIR is ``pfb_coeffs`` folded to ``(ntap, nfft)``; window
  ``w`` is ``fft(sum_t c[t] * x[(w + t) * nfft : (w + t + 1) * nfft])``;
* window ``w`` ends in row slot ``e = w + ntap - 1`` (rows are ``nfft``
  samples) and lands in spectrum ``e // wpg``, ``wpg = nblk / nout``. A
  carry from the previous block supplies the ``ntap - 1`` windows that end
  in slots ``0 .. ntap - 2``; without one they do not exist (one-shot);
* ``mean`` divides spectrum ``g`` by its window count (``wpg``, less
  ``ntap - 1`` for spectrum 0 one-shot, at least 1) times 2 pols for power
  and 1 for Stokes;
* fine channels are fftshifted per coarse channel and the output is
  ``(nout, nchan * nfft)``, or ``(nout, 4, nchan * nfft)`` (I, Q, U, V).

Blocks are the wire layout ``(ndf, nchk * 3584)`` (or the canonical 6-D
block) or series rows ``(nseries, ndf, 256)`` (or ``(nseries, ndf * 256)``)
int16. The chunk axis is processed in groups, as ``spectra_chunk_groups``
does in the JAX package, so that a full block fits the card in float64.

The carry of this package is exact for every ``nfft``: the last
``halo = (ntap - 1) * nfft`` int16 samples of each series,
``(nseries, halo, 2)``, series ``(chunk * 7 + chan) * 2 + pol``.
``history_from_jax`` takes either carry of the JAX package (its complex
``(nchk, 7, npol, halo)`` form or its fused kernels' int16 rows
``(nseries, halo / 128, 256)``), so a stream can move between the packages
mid-observation.

They are the reference for the CUDA kernel in ``ops/cuda_pfb.py``: the CPU
tests run them, and on the card they run only to check the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import NCHAN_CHK, NPOL_SAMP, NSAMP_DF
from .power import LANES_PER_CHUNK, ROW_LANES

# the fine-channel sizes the JAX package's rows path takes
# (``ops/pallas_pfb.py:FUSED_NFFTS``)
ROWS_NFFTS = (128, 256, 512, 1024)
# and the most taps it takes (``pallas_pfb.py:pfb_spectra_fused``)
ROWS_MAX_NTAP = 8


def pfb_coeffs(nfft: int, ntap: int = 4, window: str = "hamming",
               dtype=np.float32) -> np.ndarray:
    """Prototype low-pass FIR folded to ``(ntap, nfft)``: a windowed sinc
    with its cutoff at the fine-channel width, normalized to unit DC gain
    per phase (the JAX package's ``pfb_coeffs``)."""
    n = np.arange(ntap * nfft, dtype=np.float64)
    x = n / nfft - ntap / 2.0
    sinc = np.sinc(x)
    if window == "hamming":
        win = np.hamming(ntap * nfft)
    elif window == "hanning":
        win = np.hanning(ntap * nfft)
    elif window == "rect":
        win = np.ones(ntap * nfft)
    else:
        raise ValueError(f"unknown window '{window}'")
    h = (sinc * win).reshape(ntap, nfft)
    h /= h.sum(axis=0).mean()
    return h.astype(dtype)


def check_rows_nfft(nfft: int) -> None:
    """Series-row blocks take the fused kernel's sizes only (the JAX
    package's rule and message)."""
    if nfft not in ROWS_NFFTS:
        raise ValueError(
            f"device-layout PFB supports nfft in {ROWS_NFFTS} (the fused "
            f"kernel consumes rows directly), got {nfft}; re-record or use "
            "a wire-layout ring for other sizes")


def check_rows_ntap(ntap: int) -> None:
    """Series-row blocks go through the CUDA kernel only, so they take at
    most ``ROWS_MAX_NTAP`` taps (the JAX package's rows path refuses more
    too)."""
    if not 1 <= ntap <= ROWS_MAX_NTAP:
        raise ValueError(
            f"device-layout PFB supports 1 <= ntap <= {ROWS_MAX_NTAP} (the "
            f"kernel consumes rows directly), got {ntap}; use a wire-layout "
            "ring for more taps")


def spectra_chunk_groups(nchk: int) -> int:
    """Chunk-group count: the largest of 16, 12, ..., 2 dividing ``nchk``."""
    for g in (16, 12, 8, 6, 4, 3, 2):
        if nchk % g == 0:
            return g
    return 1


def block_geometry(block: torch.Tensor, layout: str
                   ) -> tuple[torch.Tensor, int, int]:
    """Validate a block; returns a view of it as int16 series frames
    ``(nchk, 7, 2, ndf, 128, 2)``, ``ndf`` and ``nchk``."""
    if layout == "wire":
        if block.ndim == 6:
            block = block.reshape(block.shape[0], -1)
        ndf, lanes = block.shape
        if lanes % LANES_PER_CHUNK:
            raise ValueError(
                f"lane dim {lanes} not a multiple of {LANES_PER_CHUNK}")
        nchk = lanes // LANES_PER_CHUNK
        series = (block.reshape(ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, 2)
                  .permute(1, 3, 4, 0, 2, 5))
    elif layout == "rows":
        if block.ndim == 2:
            if block.shape[1] % ROW_LANES:
                raise ValueError(
                    f"rows layout needs {ROW_LANES}-lane frame segments per "
                    f"series row, got {block.shape[1]} columns")
            block = block.reshape(block.shape[0], -1, ROW_LANES)
        nseries, ndf, lanes = block.shape
        if lanes != ROW_LANES or nseries % (NCHAN_CHK * NPOL_SAMP):
            raise ValueError(
                f"rows layout needs (nchk * {NCHAN_CHK * NPOL_SAMP}, ndf, "
                f"{ROW_LANES}) blocks, got {tuple(block.shape)}")
        nchk = nseries // (NCHAN_CHK * NPOL_SAMP)
        series = block.reshape(nchk, NCHAN_CHK, NPOL_SAMP, ndf, NSAMP_DF, 2)
    else:
        raise ValueError(f"unknown layout '{layout}'")
    return series, ndf, nchk


def spectra_geometry(nsamp: int, nfft: int, ntap: int,
                     nout: int) -> tuple[int, int]:
    """The golden's shape rules; returns ``(nblk, wpg)``: window slots per
    block and per spectrum."""
    if nfft < 1 or ntap < 1:
        raise ValueError(f"nfft={nfft} and ntap={ntap} must be >= 1")
    if nsamp % nfft:
        raise ValueError(f"nfft={nfft} must divide the {nsamp} samples "
                         "per block")
    nblk = nsamp // nfft
    if nout < 1 or nblk % nout:
        raise ValueError(f"nout={nout} must divide {nblk} window slots")
    wpg = nblk // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(
            f"windows per spectrum {wpg} must be >= ntap-1={ntap - 1} "
            "(boundary windows may not straddle output spectra)")
    return nblk, wpg


def mean_divisors(nout: int, wpg: int, ntap: int, stokes: bool,
                  has_history: bool) -> list[float]:
    """Per-spectrum ``mean`` divisors: the windows integrated into each
    spectrum (one-shot, spectrum 0 lacks ``ntap - 1``), clamped to at least
    1 so a spectrum with none yields 0, not NaN, times 2 pols for power."""
    n = [float(wpg)] * nout
    if not has_history:
        n[0] -= ntap - 1
    pols = 1 if stokes else NPOL_SAMP
    return [max(v, 1.0) * pols for v in n]


def history_from_jax(history, ntap: int, nfft: int,
                     npol: int = NPOL_SAMP) -> torch.Tensor:
    """Any overlap-save carry -> this package's int16 ``(nseries, halo, 2)``.

    Takes the JAX package's complex ``(nchk, 7, npol, halo)`` carry
    (``pfb_history``; its values are int16 samples, so the conversion is
    exact), its fused kernels' int16 rows ``(nseries, halo / 128, 256)``,
    or this package's own carry (returned as it is); numpy arrays or
    tensors.
    """
    h = (history if torch.is_tensor(history)
         else torch.from_numpy(np.array(history)))
    halo = (ntap - 1) * nfft
    if h.is_complex():
        nseries = h.shape[0] * NCHAN_CHK * npol
        h = torch.view_as_real(h.reshape(nseries, halo))
        return h.round().to(torch.int16).contiguous()
    if h.dtype != torch.int16 or h.ndim != 3:
        raise ValueError(f"unknown carry format {tuple(h.shape)} {h.dtype}")
    if h.shape[-1] == 2 and h.shape[1] == halo:
        return h
    if h.shape[-1] == ROW_LANES and h.shape[1] * NSAMP_DF == halo:
        return h.reshape(h.shape[0], halo, 2)
    raise ValueError(f"carry of shape {tuple(h.shape)} does not hold "
                     f"(ntap-1)*nfft={halo} samples per series")


def block_carry(history, ntap: int, nfft: int, nseries: int,
                device: torch.device) -> torch.Tensor | None:
    """``history`` (any format ``history_from_jax`` takes, or None) as a
    contiguous carry on ``device`` for a block of ``nseries`` series."""
    if history is None:
        return None
    h = history_from_jax(history, ntap, nfft).to(device)
    if h.shape[0] != nseries:
        raise ValueError(f"carry holds {h.shape[0]} series, the block "
                         f"{nseries}")
    return h.contiguous()


def history_as_complex(history, ntap: int, nfft: int,
                       npol: int = NPOL_SAMP) -> torch.Tensor:
    """Any carry -> the canonical complex64 ``(nchk, 7, npol, halo)`` form
    (the JAX package's ``pfb_history``)."""
    h = history_from_jax(history, ntap, nfft, npol)
    nchk = h.shape[0] // (NCHAN_CHK * npol)
    c = torch.view_as_complex(h.to(torch.float32).contiguous())
    return c.reshape(nchk, NCHAN_CHK, npol, -1)


def pfb_history(block: torch.Tensor, nfft: int, ntap: int = 4,
                layout: str = "wire") -> torch.Tensor:
    """The block's last ``(ntap - 1) * nfft`` samples of every series as the
    next block's carry, int16 ``(nseries, halo, 2)``. Always a tensor of
    its own, never a view of the block: a staging slot may be refilled
    while the carry is still to be read."""
    series, ndf, nchk = block_geometry(block, layout)
    halo = (ntap - 1) * nfft
    nframes = -(-halo // NSAMP_DF)
    tail = series[:, :, :, ndf - nframes:].reshape(
        nchk * NCHAN_CHK * NPOL_SAMP, nframes * NSAMP_DF, 2)
    return tail[:, nframes * NSAMP_DF - halo:].clone(
        memory_format=torch.contiguous_format)


def _detect(v: torch.Tensor, coeffs: torch.Tensor, stokes: bool
            ) -> torch.Tensor:
    """Channelize complex series ``(g, 7, 2, nsamp)`` and detect each
    window: ``(g, 7, ns, nwin, nfft)``, ns = 4 (Stokes) or 1."""
    ntap, nfft = coeffs.shape
    xr = v.reshape(v.shape[:3] + (-1, nfft))
    nwin = xr.shape[3] - (ntap - 1)
    z = coeffs[0] * xr[:, :, :, 0:nwin]
    for t in range(1, ntap):
        z = z + coeffs[t] * xr[:, :, :, t:t + nwin]
    y = torch.fft.fft(z, dim=-1)
    del z
    if not stokes:
        return (y.real.square() + y.imag.square()).sum(dim=2, keepdim=True)
    xr_, xi = y[:, :, 0].real, y[:, :, 0].imag
    yr, yi = y[:, :, 1].real, y[:, :, 1].imag
    pxx = xr_ * xr_ + xi * xi
    pyy = yr * yr + yi * yi
    return torch.stack([pxx + pyy, pxx - pyy, 2 * (xr_ * yr + xi * yi),
                        2 * (xi * yr - xr_ * yi)], dim=2)


def pfb_spectra(block: torch.Tensor, nfft: int, ntap: int = 4,
                window: str = "hamming", nout: int = 1,
                stokes: bool = False, mean: bool = False, shift: bool = True,
                history=None, return_history: bool = False,
                layout: str = "wire", dtype: torch.dtype = torch.float32):
    """PFB x waterfall x Stokes of one block (``pfb_spectra_golden``'s
    contract): float32 ``(nout, nchan * nfft)`` or, with ``stokes``,
    ``(nout, 4, nchan * nfft)`` ordered I, Q, U, V.

    ``history``: the previous block's carry in any format
    ``history_from_jax`` takes. ``dtype``: the arithmetic, float32 or
    float64 (the on-card reference). With ``return_history`` returns
    ``(out, carry)``.
    """
    series, ndf, nchk = block_geometry(block, layout)
    nblk, wpg = spectra_geometry(ndf * NSAMP_DF, nfft, ntap, nout)
    coeffs = torch.from_numpy(pfb_coeffs(nfft, ntap, window, np.float64)
                              ).to(device=block.device, dtype=dtype)
    hist = block_carry(history, ntap, nfft, nchk * NCHAN_CHK * NPOL_SAMP,
                       block.device)
    if hist is not None:
        hist = hist.reshape(nchk, NCHAN_CHK, NPOL_SAMP, (ntap - 1) * nfft, 2)
    ns = 4 if stokes else 1
    g = torch.empty((nchk, NCHAN_CHK, ns, nout, nfft), dtype=dtype,
                    device=block.device)
    first = 0 if hist is not None else ntap - 1     # slot of window 0
    gsz = nchk // spectra_chunk_groups(nchk)
    for c0 in range(0, nchk, gsz):
        x = series[c0:c0 + gsz].reshape(-1, NCHAN_CHK, NPOL_SAMP,
                                         ndf * NSAMP_DF, 2)
        if hist is not None:
            x = torch.cat([hist[c0:c0 + gsz], x], dim=3)
        v = torch.view_as_complex(x.to(dtype).contiguous())
        del x
        s = _detect(v, coeffs, stokes)               # (gsz, 7, ns, nwin, nfft)
        del v
        slots = s.new_zeros(s.shape[:3] + (nblk, nfft))
        slots[:, :, :, first:first + s.shape[3]] = s
        del s
        g[c0:c0 + gsz] = slots.reshape(
            slots.shape[:3] + (nout, wpg, nfft)).sum(dim=4)
        del slots
    if mean:
        div = torch.tensor(mean_divisors(nout, wpg, ntap, stokes,
                                         hist is not None),
                           dtype=dtype, device=block.device)
        g = g / div[:, None]
    if shift:
        g = torch.fft.fftshift(g, dim=-1)
    out = g.permute(3, 2, 0, 1, 4).reshape(nout, ns, nchk * NCHAN_CHK * nfft)
    out = out.to(torch.float32).contiguous()
    if not stokes:
        out = out[:, 0]
    if return_history:
        return out, pfb_history(block, nfft, ntap, layout)
    return out


def pfb_power(block: torch.Tensor, nfft: int, ntap: int = 4,
              window: str = "hamming", mean: bool = False, shift: bool = True,
              history=None, return_history: bool = False,
              layout: str = "wire", dtype: torch.dtype = torch.float32):
    """PFB power spectrum of one block: float32 ``(nchan * nfft,)``, the
    ``nout = 1`` power case of ``pfb_spectra`` (the JAX ``pfb_power``)."""
    res = pfb_spectra(block, nfft, ntap, window=window, mean=mean,
                      shift=shift, history=history,
                      return_history=return_history, layout=layout,
                      dtype=dtype)
    if return_history:
        return res[0][0], res[1]
    return res[0]


def make_streaming_spectra(nfft: int, ntap: int = 4, nout: int = 1,
                           stokes: bool = False, spectra=None, **kw):
    """``step(block, history) -> (spectra, new_history)``; ``spectra`` is
    the function it calls (default ``pfb_spectra``; the executor passes
    the CUDA wrapper), ``kw`` its remaining options."""
    fn = spectra or pfb_spectra

    def step(block, history):
        return fn(block, nfft, ntap, nout=nout, stokes=stokes,
                  history=history, return_history=True, **kw)

    return step


def make_streaming_pfb(nfft: int, ntap: int = 4, power=None, **kw):
    """``step(block, history) -> (power, new_history)``; ``power`` is the
    function it calls (default ``pfb_power``)."""
    fn = power or pfb_power

    def step(block, history):
        return fn(block, nfft, ntap, history=history, return_history=True,
                  **kw)

    return step
