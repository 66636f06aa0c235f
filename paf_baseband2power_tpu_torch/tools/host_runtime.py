"""Host-side native runtime microbenchmarks: ring buffer + capture engine.

The counterpart of the JAX package's ``benchmarks/host_runtime.py``, on the
port's own ``io/ringbuffer.py``, ``io/capture.py`` and ``io/sender.py``
and its own host library (``native/``, built with ``g++`` at first use).
It measures the C++ substrate that feeds the card, with the same
functions and report keys:
  1. shm ring throughput — writer fills blocks, reader drains, separate
     threads (the inter-stage fabric's memcpy ceiling on this host);
  2. the native sender's ceiling into bound but unread sockets;
  3. UDP capture loopback — native sendmmsg sender at maximum rate into
     the capture engine, frames/s and payload GB/s actually placed.
Host only: it needs no card.

Usage: python -m paf_baseband2power_tpu_torch.tools.host_runtime [--out HOST.json]
           [--port-base 28300]

``--port-base``: capture binds the loopback UDP ports from it, the
sender-only ceiling from it + 400 (by default 28300 and 28700, the JAX
script's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import uuid

import numpy as np


def bench_ring(block_mb: int = 64, nblocks: int = 24) -> dict:
    from ..io import ringbuffer as rb

    key = "hb" + uuid.uuid4().hex[:6]
    bufsz = block_mb << 20
    rb.create(key, bufsz, 4)
    src = np.random.default_rng(0).integers(
        0, 255, size=bufsz, dtype=np.uint8)
    done = {}

    def writer():
        ring = rb.RingBuffer(key)
        ring.lock_write()
        for _ in range(nblocks):
            view = ring.open_block_write()
            view[:] = src
            ring.close_block_write()
        ring.set_eod()
        ring.unlock_write()
        ring.disconnect()

    def reader():
        ring = rb.RingBuffer(key)
        ring.lock_read()
        total = 0
        while True:
            view = ring.open_block_read()
            if view is None:
                break
            total += int(view[::4096].sum())  # touch every page
            ring.close_block_read()
        ring.unlock_read()
        ring.disconnect()
        done["sum"] = total

    t0 = time.perf_counter()
    tw = threading.Thread(target=writer)
    tr = threading.Thread(target=reader)
    tw.start()
    tr.start()
    tw.join()
    tr.join()
    dt = time.perf_counter() - t0
    rb.destroy(key)
    return {
        "metric": "shm ring throughput (write + page-touch read, 2 threads)",
        "block_mb": block_mb,
        "nblocks": nblocks,
        "GBps": nblocks * bufsz / dt / 1e9,
    }


def bench_capture(seconds: float = 2.0, nchk: int = 8, nports: int = 2,
                  port_base: int = 28300) -> dict:
    from .. import constants as C
    from ..io import ringbuffer as rb
    from ..io.capture import CaptureConf, CaptureEngine
    from ..io.sender import stream_frames, stream_frames_native

    ndf = 1024
    key = "hc" + uuid.uuid4().hex[:6]
    rb.create(key, ndf * nchk * C.DT_SIZE, 8)
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=nports, ring_key=key,
        ndf_blk=ndf, nchk=nchk, freq_base=1000.0, chunk_bw=7.0,
        tbuf_ndf=256, timeout_sec=1.5, ndf_check=nchk * 2,
        zero_blocks=False,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=nports,
              nchk=nchk, freq_base=1000.0, chunk_bw=7.0, epoch=51, sec0=27)
    stop = threading.Event()

    # every probe frame has idf 0, before the reference frame the probe
    # sets: frames still queued when capture starts are dropped as late,
    # never counted as received beside the flood's
    def feed():
        while not stop.is_set():
            stream_frames(**kw, idf0=0, nframes=1, pace_sec=0.0005)

    t = threading.Thread(target=feed)
    t.start()
    try:
        eng.probe()
    finally:
        stop.set()
        t.join()
    eng.start()
    idf0 = eng.ref_idf

    # drain the ring so the writer never stalls
    def drain():
        ring = rb.RingBuffer(key)
        ring.lock_read()
        while True:
            v = ring.open_block_read(timeout_us=10_000_000)
            if v is None:
                break
            ring.close_block_read()
        ring.unlock_read()
        ring.disconnect()

    dr = threading.Thread(target=drain)
    dr.start()
    # unpaced: as fast as the sender can push
    nframes = int(seconds / C.TDF_SEC)
    t0 = time.perf_counter()
    sent = stream_frames_native(**kw, idf0=idf0, nframes=nframes, rate=0.0)
    send_dt = time.perf_counter() - t0
    eng.wait()
    dr.join()
    stats = eng.port_stats()
    recv = sum(s.received for s in stats)
    eng.close()
    rb.destroy(key)
    send_fps = sent / send_dt
    return {
        "metric": "UDP capture loopback, native sender at max rate",
        "nchk": nchk,
        "nports": nports,
        "sender_frames_per_sec": send_fps,
        "sender_GBps": send_fps * C.DF_SIZE / 1e9,
        "received_frames": int(recv),
        "received_fraction": recv / sent if sent else 0.0,
        "x_bmf_rate_sender": send_fps / (nchk / C.TDF_SEC),
        "note": "unpaced flood: sender and capture fight for the same "
                "cores, so received_fraction here is a stress figure, not "
                "a loss rate; paf_soak measures loss at the real cadence",
    }


def bench_sender_only(nchk: int = 8, nports: int = 2,
                      port_base: int = 28700,
                      nframes: int = 40000) -> dict:
    """Pure sender ceiling: frames into bound-but-unread sockets (send-path
    cost identical; no capture contending for cores). Separates the
    sender's own limit from the colocated-stress figure of
    ``bench_capture``."""
    import socket

    from .. import constants as C
    from ..io.sender import stream_frames_native

    socks = []
    for p in range(nports):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        s.bind(("127.0.0.1", port_base + p))
        socks.append(s)
    best = {}
    try:
        for burst in (8, 16, 64, 256):
            t0 = time.perf_counter()
            n = stream_frames_native(
                host="127.0.0.1", port_base=port_base, nports=nports,
                nchk=nchk, idf0=0, nframes=nframes, rate=0.0, burst=burst)
            fps = n / (time.perf_counter() - t0)
            if not best or fps > best["frames_per_sec"]:
                best = {"burst": burst, "frames_per_sec": fps}
    finally:
        for s in socks:
            s.close()
    best.update({
        "metric": "native sender ceiling (no colocated capture)",
        "GBps": best["frames_per_sec"] * C.DF_SIZE / 1e9,
        # x vs the full 48-chunk BMF rate (444,444 frames/s, capture.h:30)
        "x_bmf_rate": best["frames_per_sec"] / (C.NCHK_NIC / C.TDF_SEC),
    })
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.host_runtime")
    ap.add_argument("--out", default=None)
    ap.add_argument("--port-base", type=int, default=28300)
    args = ap.parse_args(argv)

    report = {
        "physical_cores": len(os.sched_getaffinity(0)),
        "ring": bench_ring(),
        "sender_only": bench_sender_only(port_base=args.port_base + 400),
        "capture": bench_capture(port_base=args.port_base),
    }
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
