"""Software BMF: stream synthetic frames over UDP.

The test/benchmark counterpart of the capture engine — plays the role the
beamformer FPGA plays for the reference (which has no software sender at
all; its capture path is testable only against the live instrument). Frames
follow the full wire format (64-byte big-endian header + int16 payload) and
the BMF port/chunk topology: ``nchk`` chunks spread over ``nports`` ports,
one frame per (chunk, frame-index).

Supports controlled impairment injection — drop probability, reordering
jitter — so the capture engine's late/temp-buffer/force-switch policies are
testable deterministically.

A copy of the JAX package's ``io/sender.py``; the native sender is bound on
the port's own build of ``native/sender.cpp``.
"""

from __future__ import annotations

import ctypes
import random
import socket
import time

import numpy as np

from .. import constants as C
from ..ops.frame import FrameHeader, build_frame


def stream_frames(
    host: str = "127.0.0.1",
    port_base: int = C.PORT_BASE,
    nports: int = C.NPORT_NIC,
    nchk: int = 8,
    nframes: int = 64,
    freq_base: float = 1000.0,
    chunk_bw: float = 7.0,
    epoch: int = 51,
    sec0: int = 0,
    idf0: int = 0,
    beam: int = 0,
    payload_fn=None,
    drop_prob: float = 0.0,
    shuffle_window: int = 0,
    pace_sec: float = 0.0,
    seed: int = 0,
    invalid_prob: float = 0.0,
) -> int:
    """Send ``nframes`` frame-times of ``nchk`` chunks. Returns frames sent.

    ``payload_fn(idf, ichk) -> int16 array`` supplies voltages (default:
    deterministic ramp so receivers can verify placement bit-exactly).
    ``shuffle_window > 0`` shuffles sends within that many frame-times to
    emulate network reordering; ``drop_prob`` drops frames at random;
    ``invalid_prob`` clears the header valid bit on random frames (the
    receiver must reject them, hdr.c:15-16).
    """
    rng = random.Random(seed)
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(nports)]

    if payload_fn is None:
        def payload_fn(idf, ichk):
            base = (idf * 131 + ichk * 17) % 251
            return (np.arange(C.DT_SIZE // 2, dtype=np.int16) % 199) + base

    # chunk -> port assignment: contiguous groups, like the BMF's 8-per-port
    per_port = (nchk + nports - 1) // nports

    sends = []
    for k in range(nframes):
        idf = idf0 + k
        sec = sec0
        while idf >= C.NDF_PRD:
            idf -= C.NDF_PRD
            sec += C.PRD_SEC
        for ichk in range(nchk):
            sends.append((k, idf, sec, ichk))

    if shuffle_window > 0:
        out = []
        i = 0
        while i < len(sends):
            window = sends[i:i + shuffle_window * nchk]
            rng.shuffle(window)
            out.extend(window)
            i += shuffle_window * nchk
        sends = out

    sent = 0
    last_k = -1
    for (k, idf, sec, ichk) in sends:
        if pace_sec and k != last_k:
            time.sleep(pace_sec)
            last_k = k
        if drop_prob and rng.random() < drop_prob:
            continue
        valid = 0 if (invalid_prob and rng.random() < invalid_prob) else 1
        hdr = FrameHeader(
            valid=valid, idf=idf, sec=sec, epoch=epoch,
            freq=freq_base + ichk * chunk_bw, beam=beam,
        )
        frame = build_frame(hdr, payload_fn(idf0 + k, ichk))
        port = ichk // per_port
        socks[port].sendto(frame, (host, port_base + port))
        sent += 1
    for s in socks:
        s.close()
    return sent


class _SenderConfStruct(ctypes.Structure):
    _fields_ = [
        ("host", ctypes.c_char * 64),
        ("port_base", ctypes.c_int),
        ("nports", ctypes.c_int),
        ("nchk", ctypes.c_uint32),
        ("nframes", ctypes.c_uint64),
        ("idf0", ctypes.c_uint64),
        ("sec0", ctypes.c_uint64),
        ("epoch", ctypes.c_uint32),
        ("beam", ctypes.c_uint32),
        ("freq_base", ctypes.c_double),
        ("chunk_bw", ctypes.c_double),
        ("rate", ctypes.c_double),
        ("burst", ctypes.c_uint32),
    ]


def _bind_sender(lib):
    if not getattr(lib, "_sender_bound", False):
        lib.pafb2p_sender_run.restype = ctypes.c_int64
        lib.pafb2p_sender_run.argtypes = [ctypes.POINTER(_SenderConfStruct)]
        lib._sender_bound = True
    return lib


def stream_frames_native(
    host: str = "127.0.0.1",
    port_base: int = C.PORT_BASE,
    nports: int = C.NPORT_NIC,
    nchk: int = 8,
    nframes: int = 64,
    freq_base: float = 1000.0,
    chunk_bw: float = 7.0,
    epoch: int = 51,
    sec0: int = 0,
    idf0: int = 0,
    beam: int = 0,
    rate: float = 0.0,
    burst: int = 16,
) -> int:
    """Full-rate sender: stream via ``native/sender.cpp`` (sendmmsg batches,
    one thread per port). Same wire format and deterministic ramp payloads
    as :func:`stream_frames`, but sustains the real BMF cadence — 444,444
    frames/s ~ 3.19 GB/s (capture.h:27,30) — which the Python loop cannot.

    ``rate``: pace as a multiple of real time (absolute-deadline sleeps);
    0 = send at maximum speed. Blocking; run in a thread to overlap. Returns
    frames sent.
    """
    from .ringbuffer import load_library

    lib = _bind_sender(load_library())
    s = _SenderConfStruct()
    s.host = host.encode()
    s.port_base = port_base
    s.nports = nports
    s.nchk = nchk
    s.nframes = nframes
    s.idf0 = idf0
    s.sec0 = sec0
    s.epoch = epoch
    s.beam = beam
    s.freq_base = freq_base
    s.chunk_bw = chunk_bw
    s.rate = rate
    s.burst = burst
    sent = lib.pafb2p_sender_run(ctypes.byref(s))
    if sent < 0:
        raise OSError(-sent, f"native sender failed: {-sent}")
    return int(sent)
