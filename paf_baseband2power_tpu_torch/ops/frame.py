"""BMF frames and baseband blocks on the host: the frame-header codec, the
synthetic generator and the block codecs.

A copy of the JAX package's ``ops/frame.py`` (``FrameHeader``,
``header_idf``, ``header_sec``, ``frame_distance``, ``advance_ref``,
``build_frame``, ``split_frame``, ``synthetic_block``, ``block_to_bytes``,
``bytes_to_block``, ``block_to_rows``, ``rows_to_block``), so that the port
needs nothing of that package; a test holds each against its original.

The PAF beamformer emits 7232-byte UDP frames: a 64-byte header of big-endian
64-bit words followed by 7168 bytes of int16 I/Q voltage payload. The header
bit layout follows the reference decoder (``hdr.c:10-28``):

* word 0: bit 63 ``valid``; bits 61:32 ``sec`` (seconds since period start,
  30-bit field); bits 31:0 ``idf`` (frame index within the 27 s period).
* word 1: bits 31:26 ``epoch`` (half-years since 2000-01-01).
* word 2: bits 31:16 ``freq`` (first channel frequency of the chunk, MHz);
  bits 15:0 ``beam`` id.

The payload is [sample (128)][channel (7)][pol (2)][I,Q int16],
little-endian. A block is int16 voltages ``(ndf, nchk, NSAMP_DF, NCHAN_CHK,
NPOL_SAMP, NDIM_POL)``: the TFTFP ring-block layout the capture stage
writes (``capture.c:540-544``). Series rows are the corner-turned form of
``capture --device-layout``: ``(nchk * 14, ndf, 256)``, one row per
(chunk, channel, pol) with re/im interleaved on the lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    DF_SIZE,
    DT_SIZE,
    HDR_SIZE,
    NCHAN_CHK,
    NCHK_NIC,
    NDF_BLK,
    NDF_PRD,
    NDIM_POL,
    NPOL_SAMP,
    NSAMP_DF,
)

FRAME_PAYLOAD_SHAPE = (NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)
PAYLOAD_DTYPE = np.dtype("<i2")


@dataclasses.dataclass
class FrameHeader:
    """Decoded BMF frame header (mirrors ``hdr_t``, ``hdr.h:6-14``)."""

    valid: int = 0
    idf: int = 0          # data-frame index within the 27 s period
    sec: int = 0          # seconds from epoch to period start
    epoch: int = 0        # half-years since 2000-01-01
    beam: int = 0
    freq: float = 0.0     # first channel of the chunk, integer MHz

    def pack(self) -> bytes:
        """Encode to the 64-byte big-endian wire format."""
        w = np.zeros(HDR_SIZE // 8, dtype=">u8")
        w[0] = (
            ((self.valid & 0x1) << 63)
            | ((self.sec & 0x3FFFFFFF) << 32)
            | (self.idf & 0xFFFFFFFF)
        )
        w[1] = (self.epoch & 0x3F) << 26
        w[2] = ((int(self.freq) & 0xFFFF) << 16) | (self.beam & 0xFFFF)
        return w.tobytes()

    @classmethod
    def unpack(cls, buf: bytes | memoryview | np.ndarray) -> "FrameHeader":
        """Decode from the first 64 bytes of a frame (``hdr.c:10-28``)."""
        w = np.frombuffer(buf, dtype=">u8", count=HDR_SIZE // 8)
        w0, w1, w2 = int(w[0]), int(w[1]), int(w[2])
        return cls(
            valid=(w0 >> 63) & 0x1,
            sec=(w0 >> 32) & 0x3FFFFFFF,
            idf=w0 & 0xFFFFFFFF,
            epoch=(w1 >> 26) & 0x3F,
            freq=float((w2 >> 16) & 0xFFFF),
            beam=w2 & 0xFFFF,
        )


def header_idf(buf) -> int:
    """Fast path for the frame index (``hdr_idf``, ``hdr.c:30-37``)."""
    w0 = int(np.frombuffer(buf, dtype=">u8", count=1)[0])
    return w0 & 0xFFFFFFFF


def header_sec(buf) -> int:
    w0 = int(np.frombuffer(buf, dtype=">u8", count=1)[0])
    return (w0 >> 32) & 0x3FFFFFFF


def frame_distance(hdr: FrameHeader, ref: FrameHeader) -> int:
    """Signed frame count from ``ref`` to ``hdr``, wrap-aware
    (``acquire_idf``, ``capture.c:562-568``): sec deltas are multiples of
    the 27 s period, so ``dsec * NDF_PRD / 27`` is exact."""
    return (hdr.idf - ref.idf) + (hdr.sec - ref.sec) * NDF_PRD // 27


def advance_ref(ref: FrameHeader, ndf: int) -> FrameHeader:
    """Advance a reference header by ``ndf`` frames with 27 s wraparound
    (the sync thread's block rotation, ``sync.c:115-127``)."""
    idf = ref.idf + ndf
    sec = ref.sec
    while idf >= NDF_PRD:
        idf -= NDF_PRD
        sec += 27
    return dataclasses.replace(ref, idf=idf, sec=sec)


def build_frame(hdr: FrameHeader, payload: np.ndarray) -> bytes:
    """Assemble one 7232-byte wire frame."""
    payload = np.ascontiguousarray(payload, dtype=PAYLOAD_DTYPE)
    if payload.nbytes != DT_SIZE:
        raise ValueError(f"payload must be {DT_SIZE} bytes, got {payload.nbytes}")
    return hdr.pack() + payload.tobytes()


def split_frame(frame: bytes | memoryview) -> tuple[FrameHeader, np.ndarray]:
    """Decode one wire frame into (header, payload[int16 view])."""
    if len(frame) != DF_SIZE:
        raise ValueError(f"frame must be {DF_SIZE} bytes, got {len(frame)}")
    hdr = FrameHeader.unpack(frame)
    payload = np.frombuffer(frame, dtype=PAYLOAD_DTYPE, offset=HDR_SIZE).reshape(
        FRAME_PAYLOAD_SHAPE
    )
    return hdr, payload


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
