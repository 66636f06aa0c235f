"""NumPy golden model for the baseband->power conversion.

This is the parity oracle for every device kernel in the framework. It
implements, in double precision, the compute contract the reference specifies
but never shipped (usage string ``paf_baseband2power.cu:20`` "detect baseband
data with original channels and average the detected data in time"; output
spec ``header_baseband2power.txt:39-42``: NBIT 32, NDIM 1, NPOL 1, NCHAN 336;
integration length ``README.md:2``: 1024*1024 samples = 0.884736 s):

    unpack int16 I/Q -> |x|^2 summed over both polarizations -> sum over
    exactly NSAMP_INT time samples -> one float32 power per channel.

One input ring block (8192 frames x 48 chunks) holds exactly one integration
window (8192 * 128 = 1024^2 samples), so the model is purely per-block.
"""

from __future__ import annotations

import numpy as np

from ..constants import BLOCK_SHAPE, NCHAN, NCHAN_CHK, NCHK_NIC


def baseband2power_golden(block: np.ndarray, mean: bool = False) -> np.ndarray:
    """Reference power integration in float64.

    Parameters
    ----------
    block:
        int16 voltages shaped ``(ndf, nchk, nsamp_df, nchan_chk, npol, ndim)``
        (the canonical TFTFP block layout; any leading ``ndf``/``nchk`` sizes
        are accepted for small-scale testing).
    mean:
        If True, divide by the number of integrated samples ("average the
        detected data in time"); default False matches straight integration
        (the two differ by the constant 1/NSAMP_INT only).

    Returns
    -------
    float32 power of shape ``(nchk * nchan_chk,)`` — 336 channels for the
    full geometry, ordered channel-major by chunk.
    """
    if block.ndim != len(BLOCK_SHAPE):
        raise ValueError(f"expected {len(BLOCK_SHAPE)}-d block, got {block.shape}")
    ndf, nchk, nsamp, nchan_chk, npol, ndim = block.shape
    x = block.astype(np.float64)
    # |x|^2 over I/Q, summed over both pols, all samples, all frames.
    power = np.einsum("fcsknd,fcsknd->ck", x, x, optimize=True)
    if mean:
        power = power / (ndf * nsamp * npol)
    return power.reshape(nchk * nchan_chk).astype(np.float32)


def baseband2power_scrunch_golden(block: np.ndarray, nout: int,
                                  mean: bool = False) -> np.ndarray:
    """Sub-block integration: ``nout`` spectra per block (float64 oracle).

    Capability extension: the reference hard-codes one spectrum per block
    (1024^2 samples); here the block's frames split into ``nout`` equal
    windows, each integrated independently — e.g. nout=1024 gives 864 us
    cadence from the same stream. ``nout=1`` row equals
    :func:`baseband2power_golden`.

    Returns float32 of shape ``(nout, nchk * nchan_chk)``.
    """
    ndf = block.shape[0]
    if ndf % nout:
        raise ValueError(f"nout={nout} must divide ndf={ndf}")
    x = block.astype(np.float64)
    ndf_w = ndf // nout
    xw = x.reshape((nout, ndf_w) + x.shape[1:])
    power = np.einsum("wfcsknd,wfcsknd->wck", xw, xw, optimize=True)
    if mean:
        power = power / (ndf_w * block.shape[2] * block.shape[4])
    return power.reshape(nout, -1).astype(np.float32)


def baseband2stokes_golden(block: np.ndarray, mean: bool = False) -> np.ndarray:
    """Full-Stokes detection in float64 (capability extension).

    The reference's output is total power only (NPOL 1); with both
    polarizations on the wire the full Stokes set costs the same HBM pass,
    so the framework offers it as a mode. Definitions (x = pol 0, y = pol 1
    complex voltages; PSR/IEEE convention):

        I = <|x|^2 + |y|^2>      Q = <|x|^2 - |y|^2>
        U = 2 Re<x y*>           V = 2 Im<x y*>

    Returns float32 of shape ``(4, nchk * nchan_chk)``, ordered I, Q, U, V.
    ``stokes[0]`` equals :func:`baseband2power_golden` exactly in sum mode
    (``mean=True`` here averages over samples only, the Stokes convention,
    not over samples*pols).
    """
    if block.ndim != len(BLOCK_SHAPE):
        raise ValueError(f"expected {len(BLOCK_SHAPE)}-d block, got {block.shape}")
    ndf, nchk, nsamp, nchan_chk, npol, ndim = block.shape
    if npol != 2 or ndim != 2:
        raise ValueError("Stokes needs 2 pols x 2 dims")
    v = block.astype(np.float64)
    x = v[..., 0, 0] + 1j * v[..., 0, 1]      # (ndf, nchk, nsamp, nchan)
    y = v[..., 1, 0] + 1j * v[..., 1, 1]
    xx = np.einsum("fcsk,fcsk->ck", x.real, x.real, optimize=True) + \
        np.einsum("fcsk,fcsk->ck", x.imag, x.imag, optimize=True)
    yy = np.einsum("fcsk,fcsk->ck", y.real, y.real, optimize=True) + \
        np.einsum("fcsk,fcsk->ck", y.imag, y.imag, optimize=True)
    xy = np.einsum("fcsk,fcsk->ck", x, np.conj(y), optimize=True)
    stokes = np.stack([
        xx + yy,
        xx - yy,
        2.0 * xy.real,
        2.0 * xy.imag,
    ])
    if mean:
        stokes = stokes / (ndf * nsamp)
    return stokes.reshape(4, nchk * nchan_chk).astype(np.float32)


def baseband2stokes_scrunch_golden(block: np.ndarray, nout: int,
                                   mean: bool = False) -> np.ndarray:
    """Composed Stokes x sub-block integration oracle (coarse channels):
    ``nout`` I/Q/U/V spectra per block, float64 accumulation.

    Returns float32 of shape ``(nout, 4, nchk * nchan_chk)``; ``nout=1``
    row equals :func:`baseband2stokes_golden`.
    """
    ndf = block.shape[0]
    if ndf % nout:
        raise ValueError(f"nout={nout} must divide ndf={ndf}")
    ndf_w = ndf // nout
    out = np.stack([
        baseband2stokes_golden(block[w * ndf_w:(w + 1) * ndf_w], mean=mean)
        for w in range(nout)
    ])
    return out


def expected_output_nbytes(nchk: int = NCHK_NIC) -> int:
    return nchk * NCHAN_CHK * 4


__all__ = [
    "baseband2power_golden",
    "baseband2power_scrunch_golden",
    "baseband2stokes_golden",
    "expected_output_nbytes",
    "NCHAN",
]
