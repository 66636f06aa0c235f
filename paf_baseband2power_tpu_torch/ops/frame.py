"""Baseband blocks on the host: the synthetic generator and the block codecs.

The part of the JAX package's ``ops/frame.py`` the port uses
(``synthetic_block``, ``block_to_bytes``, ``bytes_to_block``,
``block_to_rows``, ``rows_to_block``), copied so that the port needs
nothing of that package; a test holds each against its original.

A block is int16 voltages ``(ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP,
NDIM_POL)``, little-endian: the TFTFP ring-block layout the capture stage
writes (``capture.c:540-544``). Series rows are the corner-turned form of
``capture --device-layout``: ``(nchk * 14, ndf, 256)``, one row per
(chunk, channel, pol) with re/im interleaved on the lanes.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    NCHAN_CHK,
    NCHK_NIC,
    NDF_BLK,
    NDIM_POL,
    NPOL_SAMP,
    NSAMP_DF,
)

PAYLOAD_DTYPE = np.dtype("<i2")


def synthetic_block(
    rng: np.random.Generator | int | None = 0,
    ndf: int = NDF_BLK,
    nchk: int = NCHK_NIC,
    scale: float = 64.0,
    dtype=np.int16,
) -> np.ndarray:
    """Gaussian noise at ``scale`` LSB rms (beamformed sky noise) as an int16
    block ``(ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)``."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    shape = (ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)
    x = rng.normal(0.0, scale, size=shape)
    return np.clip(np.rint(x), -32768, 32767).astype(dtype)


def block_to_bytes(block: np.ndarray) -> bytes:
    """Serialize a block array to the ring-buffer wire layout (C order)."""
    return np.ascontiguousarray(block, dtype=PAYLOAD_DTYPE).tobytes()


def bytes_to_block(buf, ndf: int = NDF_BLK, nchk: int = NCHK_NIC) -> np.ndarray:
    """View ring-buffer bytes as the canonical block array (zero copy)."""
    shape = (ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)
    return np.frombuffer(buf, dtype=PAYLOAD_DTYPE).reshape(shape)


def block_to_rows(block: np.ndarray) -> np.ndarray:
    """Canonical 6-D block -> series rows ``(nseries, ndf, 256) int16`` (the
    host corner turn of ``capture --device-layout``)."""
    ndf, nchk = block.shape[0], block.shape[1]
    return np.ascontiguousarray(
        block.transpose(1, 3, 4, 0, 2, 5).reshape(
            nchk * NCHAN_CHK * NPOL_SAMP, ndf, 2 * NSAMP_DF))


def rows_to_block(rows: np.ndarray, ndf: int, nchk: int) -> np.ndarray:
    """Inverse of :func:`block_to_rows` (series rows -> canonical 6-D)."""
    r6 = rows.reshape(nchk, NCHAN_CHK, NPOL_SAMP, ndf, NSAMP_DF, 2)
    return np.ascontiguousarray(r6.transpose(3, 0, 4, 1, 2, 5))
