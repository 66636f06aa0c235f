"""DADA header and file I/O.

The reference's entire inter-stage metadata protocol is the PSRDADA ASCII
header: a 4096-byte block of ``KEY  value`` lines, NUL-padded, carried in
front of every data stream (template ``header_baseband2power.txt``, filled at
runtime with UTC_START/PICOSECONDS/FREQ by ``register_header``,
``capture.c:727-789``). Recorded streams are ``.dada`` files: one 4096-byte
header followed by raw payload, replayable by ``paf_diskdb`` (``diskdb.cu:
74-124``, which seeks past the file header and streams whole ring blocks).

This module implements the format natively: a typed header codec plus
streaming readers/writers used by the disk replay source and the disk spill
sink. No PSRDADA code involved — the format is the contract.

A copy of the JAX package's ``io/dada.py``: the two packages read each
other's recordings, so the copy must write exactly the same bytes (a test
holds it byte-equal to the original).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..constants import (
    DADA_HDR_SIZE,
    NCHAN,
    OUT_NBIT,
    OUT_NDIM,
    OUT_NPOL,
    TINT,
)


class DadaHeader(dict):
    """Ordered KEY->string mapping with DADA ASCII serialization."""

    @classmethod
    def parse(cls, buf: bytes | str) -> "DadaHeader":
        if isinstance(buf, bytes):
            buf = buf.split(b"\0", 1)[0].decode("ascii", errors="replace")
        hdr = cls()
        for line in buf.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            key = parts[0]
            hdr[key] = parts[1].strip() if len(parts) > 1 else ""
        return hdr

    def serialize(self, size: int = DADA_HDR_SIZE) -> bytes:
        lines = [f"{k:<12} {v}" for k, v in self.items()]
        raw = ("\n".join(lines) + "\n").encode("ascii")
        if len(raw) > size:
            raise ValueError(f"header {len(raw)} B exceeds {size} B block")
        return raw.ljust(size, b"\0")

    # typed accessors -------------------------------------------------------
    def get_int(self, key: str, default: int | None = None) -> int:
        v = self.get(key)
        if v is None or v == "unset":
            if default is None:
                raise KeyError(key)
            return default
        return int(float(v))

    def get_float(self, key: str, default: float | None = None) -> float:
        v = self.get(key)
        if v is None or v == "unset":
            if default is None:
                raise KeyError(key)
            return default
        return float(v)


def output_header(
    utc_start: str = "unset",
    picoseconds: int | str = "unset",
    freq: float | str = "unset",
    bw: float | str = "unset",
    nchan: int = NCHAN,
    source: str = "unset",
    extra: dict | None = None,
    tint_sec: float | None = None,
) -> DadaHeader:
    """Build the power-output header (parity with the fields of
    ``header_baseband2power.txt:1-45``: NBIT 32 float, NDIM 1, NPOL 1,
    NCHAN 336, Effelsberg PAF-BMF instrument block, runtime-set
    UTC_START/PICOSECONDS/FREQ).

    TSAMP is the integration time in microseconds (0.884736 s; the
    reference template's 88473.6 carries a known factor-10 typo — the
    README/block math value is authoritative, SURVEY.md section 0.1).
    ``tint_sec`` overrides it for non-standard block geometries (reduced
    ``--ndf`` test streams), keeping TSAMP = actual seconds per record.
    """
    tsamp_us = float(TINT if tint_sec is None else tint_sec) * 1e6
    hdr = DadaHeader(
        HEADER="DADA",
        HDR_VERSION="1.0",
        HDR_SIZE=str(DADA_HDR_SIZE),
        DADA_VERSION="1.0",
        OBS_ID="unset",
        FILE_SIZE="unset",
        FILE_NUMBER="0",
        UTC_START=utc_start,
        MJD_START="unset",
        PICOSECONDS=str(picoseconds),
        OBS_OFFSET="0",
        OBS_OVERLAP="0",
        SOURCE=source,
        RA="unset",
        DEC="unset",
        TELESCOPE="Effelsberg",
        INSTRUMENT="PAF-BMF",
        RECEIVER="PAF",
        FREQ=str(freq),
        BW=str(bw),
        TSAMP=f"{tsamp_us:.6f}",
        BYTES_PER_SECOND=(
            f"{nchan * 4 / float(TINT if tint_sec is None else tint_sec):.6f}"
        ),
        NBIT=str(OUT_NBIT),
        NDIM=str(OUT_NDIM),
        NPOL=str(OUT_NPOL),
        NCHAN=str(nchan),
        RESOLUTION="1",
        DSB="1",
    )
    if extra:
        hdr.update({k: str(v) for k, v in extra.items()})
    return hdr


def baseband_header(
    utc_start: str = "unset",
    picoseconds: int | str = "unset",
    freq: float | str = "unset",
    nchan: int = NCHAN,
    extra: dict | None = None,
) -> DadaHeader:
    """Header for recorded baseband (the input-stream side)."""
    hdr = output_header(utc_start, picoseconds, freq, nchan=nchan)
    hdr.update(
        NBIT="16",
        NDIM="2",
        NPOL="2",
        NCHAN=str(nchan),
        TSAMP="0.843750",  # 27/32 us
        INSTRUMENT="PAF-BMF",
    )
    if extra:
        hdr.update({k: str(v) for k, v in extra.items()})
    return hdr


class DadaFileWriter:
    """Write a .dada stream: 4096 B header then raw records."""

    def __init__(self, path: str, header: DadaHeader):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(header.serialize())
        self.nbytes = 0

    def write(self, payload: bytes | np.ndarray) -> None:
        if isinstance(payload, np.ndarray):
            payload = payload.tobytes()
        self._f.write(payload)
        self.nbytes += len(payload)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DadaFileReader:
    """Read a .dada stream: header + block iterator.

    Mirrors ``do_diskdb`` (``diskdb.cu:103-121``): seek past the 4096 B
    file header, then read fixed-size blocks until EOF; a final partial
    block is dropped (the reference reads whole ring blocks only).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        raw = self._f.read(DADA_HDR_SIZE)
        if len(raw) < DADA_HDR_SIZE:
            raise ValueError(f"{path}: truncated DADA header")
        self.header = DadaHeader.parse(raw)
        self.payload_bytes = os.path.getsize(path) - DADA_HDR_SIZE

    def skip(self, nbytes: int) -> None:
        """Skip payload bytes (resume support: OBS_OFFSET semantics)."""
        self._f.seek(nbytes, 1)

    def blocks(self, block_nbytes: int,
               allow_partial: bool = False) -> Iterator[bytes]:
        while True:
            buf = self._f.read(block_nbytes)
            if not buf:
                return
            if len(buf) < block_nbytes and not allow_partial:
                return
            yield buf

    def read_all(self) -> bytes:
        return self._f.read()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
