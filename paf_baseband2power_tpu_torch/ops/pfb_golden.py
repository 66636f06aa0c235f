"""NumPy float64 golden models of the PFB spectrometer.

A copy of the golden half of ``paf_baseband2power_tpu/ops/pfb.py``
(``pfb_coeffs``, ``channelize_golden``, ``pfb_power_golden``,
``pfb_spectra_golden``): that module imports ``jax`` when it loads, so the
port keeps its own copy of the numpy functions, statement for statement
(the docstrings too, except that ``pfb_spectra_golden``'s names the
reference's ``kernel.cuh`` by its path in the reference's tree).
``tests/test_torch_standalone.py`` holds each one equal to its original.
They are the independent references of ``parity.py``'s sweeps.
"""

from __future__ import annotations

import numpy as np


def pfb_coeffs(nfft: int, ntap: int = 4, window: str = "hamming",
               dtype=np.float32) -> np.ndarray:
    """Prototype low-pass FIR folded to ``(ntap, nfft)``.

    Windowed sinc with cutoff at the fine-channel width (the conventional
    PFB prototype). Normalized to unit DC gain per phase so a constant
    input maps to the k=0 fine channel with unchanged amplitude scale.
    """
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


# --------------------------------------------------------------------------
# Golden (NumPy, float64) reference
# --------------------------------------------------------------------------

def channelize_golden(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Brute-force PFB: x (..., nsamp) complex -> (..., nwin, nfft) complex."""
    ntap, nfft = coeffs.shape
    nsamp = x.shape[-1]
    nwin = nsamp // nfft - (ntap - 1)
    out_shape = x.shape[:-1] + (nwin, nfft)
    y = np.zeros(out_shape, dtype=np.complex128)
    xr = x.reshape(x.shape[:-1] + (nsamp // nfft, nfft))
    for m in range(nwin):
        z = np.zeros(x.shape[:-1] + (nfft,), dtype=np.complex128)
        for t in range(ntap):
            z = z + coeffs[t] * xr[..., m + t, :]
        y[..., m, :] = np.fft.fft(z, axis=-1)
    return y


def pfb_power_golden(block: np.ndarray, nfft: int, ntap: int = 4,
                     window: str = "hamming", mean: bool = False,
                     shift: bool = True) -> np.ndarray:
    """Golden PFB spectrometer on a canonical 6-D block.

    Returns float32 power of shape ``(nchk * NCHAN_CHK * nfft,)``.
    """
    ndf, nchk, nsamp_df, nchan_chk, npol, ndim = block.shape
    x = block.astype(np.float64)
    v = x[..., 0] + 1j * x[..., 1]                      # (ndf,nchk,ns,nk,np)
    # time series per (chunk, chan, pol): n = f*nsamp_df + s
    v = v.transpose(1, 3, 4, 0, 2).reshape(nchk, nchan_chk, npol,
                                           ndf * nsamp_df)
    coeffs = pfb_coeffs(nfft, ntap, window, dtype=np.float64)
    y = channelize_golden(v, coeffs)                    # (...,nwin,nfft)
    p = np.abs(y) ** 2
    power = p.sum(axis=(2, 3))                          # sum pol, windows
    if mean:
        power = power / (p.shape[2] * p.shape[3])
    if shift:
        power = np.fft.fftshift(power, axes=-1)
    return power.reshape(nchk * nchan_chk * nfft).astype(np.float32)


def pfb_spectra_golden(block: np.ndarray, nfft: int, ntap: int = 4,
                       window: str = "hamming", nout: int = 1,
                       stokes: bool = False, mean: bool = False,
                       shift: bool = True) -> np.ndarray:
    """Golden composed fine-channel detection: PFB x tscrunch x Stokes.

    The reference's planned channelizer (``reference/kernel.cuh:4-7``,
    ``makefile:27`` cuFFT) composed with its "detect ... and average ... in
    time" contract (``paf_baseband2power.cu:20``) implies what F-engine
    backends actually ship: fine-channel spectra *with time resolution*
    (a waterfall) and fine-channel polarimetry. This is the float64 oracle
    for both, and for their composition.

    Window-group convention (streaming-consistent): window ``w`` ends in
    row-slot ``e = w + ntap - 1`` (rows are ``nfft``-sample blocks); its
    output spectrum is ``e // (nblk / nout)``. Boundary windows carried in
    from the previous block end in rows ``0..ntap-2`` and so land in
    spectrum 0 — a two-block stream with history reproduces the one-shot
    golden over the concatenated series exactly, group by group.

    Returns float32 ``(nout, nchan * nfft)`` or, with ``stokes``,
    ``(nout, 4, nchan * nfft)`` ordered I, Q, U, V.
    """
    ndf, nchk, nsamp_df, nchan_chk, npol, ndim = block.shape
    nsamp = ndf * nsamp_df
    nblk = nsamp // nfft
    if nblk % nout:
        raise ValueError(f"nout={nout} must divide {nblk} window slots")
    wpg = nblk // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(
            f"windows per spectrum {wpg} must be >= ntap-1={ntap - 1} "
            "(boundary windows may not straddle output spectra)")
    x = block.astype(np.float64)
    v = (x[..., 0] + 1j * x[..., 1]).transpose(1, 3, 4, 0, 2).reshape(
        nchk, nchan_chk, npol, nsamp)
    coeffs = pfb_coeffs(nfft, ntap, window, dtype=np.float64)
    y = channelize_golden(v, coeffs)        # (chk, chan, pol, nwin, nfft)
    nwin = y.shape[-2]
    if stokes:
        if npol != 2:
            raise ValueError("Stokes needs 2 polarizations")
        yx, yy = y[:, :, 0], y[:, :, 1]
        pxx = np.abs(yx) ** 2
        pyy = np.abs(yy) ** 2
        xy = yx * np.conj(yy)
        s = np.stack([pxx + pyy, pxx - pyy, 2 * xy.real, 2 * xy.imag],
                     axis=2)                # (chk, chan, 4, nwin, nfft)
    else:
        s = (np.abs(y) ** 2).sum(axis=2)[:, :, None]   # (.., 1, nwin, nfft)
    slots = np.zeros(s.shape[:3] + (nblk, nfft))
    slots[..., ntap - 1:ntap - 1 + nwin, :] = s
    g = slots.reshape(s.shape[:3] + (nout, wpg, nfft)).sum(axis=-2)
    if mean:
        nwin_g = np.full(nout, float(wpg))
        nwin_g[0] -= ntap - 1               # one-shot: no boundary windows
        # wpg == ntap-1 leaves spectrum 0 with zero windows one-shot (its
        # sum is exactly 0); clamp so mean mode yields 0, not 0/0 = NaN
        nwin_g = np.maximum(nwin_g, 1.0)
        denom = nwin_g * (1 if stokes else npol)
        g = g / denom[:, None]
    if shift:
        g = np.fft.fftshift(g, axes=-1)
    out = g.transpose(3, 2, 0, 1, 4).reshape(nout, s.shape[2],
                                             nchk * nchan_chk * nfft)
    out = out.astype(np.float32)
    return out if stokes else out[:, 0]
