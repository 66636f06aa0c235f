"""CLI: end-to-end real-time soak test.

Streams synthetic BMF frames at the true frame cadence (one frame-time per
TDF = 108 us per chunk set) through the full live topology — UDP capture ->
ring -> CUDA compute -> memory sink — for a configured duration, then
reports whether the pipeline held real time: packet loss, blocks committed
vs expected, compute margin and the kernel launches of the soak.

This is the test the reference could only run against the live telescope;
geometry is scalable so the soak runs meaningfully on any host (full
geometry at 3.19 GB/s needs a real NIC path).

A port of the JAX package's ``paf_soak`` onto the port's capture engine and
``PowerPipeline``. ``--platform cuda`` (the default) runs the CUDA kernels
and exits 2 at once without a GPU; ``--platform cpu`` runs their plain
PyTorch versions. Run ``python -m paf_baseband2power_tpu_torch.cli.paf_soak
--seconds 5 --ndf 1024 --nchk 2 --nports 1 --platform cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import uuid


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_soak")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--ndf", type=int, default=64, help="frames per block")
    ap.add_argument("--nchk", type=int, default=8)
    ap.add_argument("--nblk", type=int, default=8,
                    help="ring depth in blocks; deeper rings absorb compute "
                    "stalls on core-starved hosts (NBLK analogue, "
                    "paf-baseband2power.conf:11)")
    ap.add_argument("--nports", type=int, default=2)
    ap.add_argument("--tbuf", type=int, default=0,
                    help="late-frame temp buffer depth in frames; 0 = "
                    "ndf/4 clamped to [32, 256] (the reference's "
                    "TBUF_NDF=256, capture.h:33 — at rate 1.0 each frame "
                    "is 108 us, so this is the scheduling-stall slack "
                    "before a force-switch drops a block tail)")
    ap.add_argument("--port-base", type=int, default=29100)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="stream rate as a multiple of real time. Rates the "
                    "host cannot hold correctly FAIL the soak (capture "
                    "quits when a port falls a block behind, the "
                    "reference's own policy)")
    ap.add_argument("--sender", choices=["native", "py"], default="native",
                    help="native = C++ sendmmsg sender (sustains the real "
                    "BMF cadence, capture.h:27,30); py = the Python sender "
                    "(~0.25x real time on loopback)")
    ap.add_argument("--max-loss", type=float, default=0.05,
                    help="fail threshold for packet loss")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the CUDA kernels (fails without a GPU); "
                    "cpu: their plain PyTorch versions")
    ap.add_argument("--device-layout", action="store_true",
                    help="capture corner-turns frames on the host into the "
                    "series-row layout (SIMD); compute consumes rows "
                    "with zero device relayout")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="soak with the fine channelizer as the compute "
                    "stage (streaming overlap-save carry across live "
                    "blocks)")
    ap.add_argument("--ntap", type=int, default=4)
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes detection as the compute stage")
    ap.add_argument("--nspectra", type=int, default=1,
                    help="sub-block integration: N spectra per block")
    ap.add_argument("--spill", metavar="DIR", default=None,
                    help="full reference topology: create the ring with "
                    "NREADER=2 and run a second reader spilling raw "
                    "baseband to DIR/<UTC>.dada concurrently with compute "
                    "(the dada_dbdisk tap, paf-baseband2power.py:117-127)")
    ap.add_argument("-k", "--dir", default=None, help="log directory")
    args = ap.parse_args(argv)
    if args.tbuf and not 0 < args.tbuf <= args.ndf:
        ap.error(f"--tbuf must be in [1, --ndf={args.ndf}]: the native "
                 "engine rejects a temp buffer deeper than one ring block")

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available "
                 "(--platform cpu runs the plain PyTorch path)")
    device = torch.device("cuda", 0) if args.platform == "cuda" else "cpu"

    from .. import constants as C
    from ..io import ringbuffer as rb
    from ..runtime.log import open_log

    log = open_log("paf_soak", args.dir)
    key = "sk" + uuid.uuid4().hex[:6]
    rb.create(key, args.ndf * args.nchk * C.DT_SIZE, args.nblk,
              nreader=2 if args.spill else 1)
    # the shm ring must not leak if engine construction / warmup / the
    # soak body raises — everything below runs under this finally
    try:
        report = _soak(args, key, log, device)
    finally:
        if rb.exists(key):
            rb.destroy(key)
    log.info("soak: %s", report)
    print(json.dumps(report))
    return 0 if report["pass"] else 1


def _soak(args, key: str, log, device) -> dict:
    from .. import constants as C
    from ..io.capture import CaptureConf, CaptureEngine
    from ..runtime.pipeline import MemorySink, PowerPipeline

    # build and run the compute step BEFORE any real-time machinery
    # starts: a first-block kernel build would stall the ring reader, fill
    # the ring, and trip capture's fall-behind quit
    sink = MemorySink()
    pipe = PowerPipeline(device, log_dir=args.dir,
                         name="paf_soak_compute",
                         device_layout=args.device_layout,
                         pfb_nfft=args.pfb, pfb_ntap=args.ntap,
                         stokes=args.stokes, nout=args.nspectra)
    warmup_sec = pipe.warmup(args.ndf, args.nchk)

    frame_time = float(C.TDF) / args.rate      # per frame-time across chunks
    total_frames = int(args.seconds / frame_time)
    kw = dict(host="127.0.0.1", port_base=args.port_base,
              nports=args.nports, nchk=args.nchk, freq_base=1000.0,
              chunk_bw=7.0, epoch=51, sec0=27)

    conf = CaptureConf(
        ip="127.0.0.1", port_base=args.port_base, nports=args.nports,
        ring_key=key, ndf_blk=args.ndf, nchk=args.nchk, freq_base=1000.0,
        chunk_bw=7.0,
        tbuf_ndf=args.tbuf or min(max(args.ndf // 4, 32), 256, args.ndf),
        timeout_sec=2.0,
        ndf_check=args.nchk * 2, zero_blocks=True,
        device_layout=args.device_layout,
    )
    eng = CaptureEngine(conf)
    try:
        return _soak_with_engine(args, key, eng, pipe, sink, warmup_sec,
                                 frame_time, total_frames, kw)
    finally:
        eng.close()


def _soak_with_engine(args, key, eng, pipe, sink, warmup_sec, frame_time,
                      total_frames, kw) -> dict:
    import threading
    import time

    from .. import constants as C
    from ..io import ringbuffer as rb
    from ..io.ringbuffer import RingSource
    from ..io.sender import stream_frames, stream_frames_native

    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**kw, idf0=0, nframes=args.nchk * 2,
                          pace_sec=0.0005)

    tx0 = threading.Thread(target=probe_feed)
    tx0.start()
    try:
        eng.probe()
    finally:
        probe_done.set()
        tx0.join()
    eng.start()
    idf0 = eng.ref_idf

    # register the stream header so ring readers can attach
    from ..io.dada import baseband_header
    from ..ops.time_utils import start_time

    utc, ps = start_time(eng.epoch, eng.ref_sec, eng.ref_idf)
    with rb.RingBuffer(key) as ring:
        ring.write_header(baseband_header(
            utc_start=utc, picoseconds=ps, freq=eng.freq_center,
            nchan=args.nchk * C.NCHAN_CHK,
            extra={"ORDER": "SERIES"} if args.device_layout else None))

    # paced sender: the native one paces itself on absolute deadlines; the
    # Python fallback sleeps to schedule between bursts
    if args.sender == "native":
        def paced_sender():
            stream_frames_native(**kw, idf0=idf0, nframes=total_frames,
                                 rate=args.rate)
    else:
        def paced_sender():
            burst = 8
            t0 = time.perf_counter()
            sent_ft = 0
            while sent_ft < total_frames:
                n = min(burst, total_frames - sent_ft)
                stream_frames(**kw, idf0=idf0 + sent_ft, nframes=n)
                sent_ft += n
                target = t0 + sent_ft * frame_time
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)

    tx = threading.Thread(target=paced_sender)

    # compute stage on the ring, in this process (step built above); its
    # failure is raised once the stream has ended
    result = {}

    def compute():
        try:
            src = RingSource(key, ndf=args.ndf, nchk=args.nchk,
                             layout="rows" if args.device_layout else "wire")
            result["stats"] = pipe.run(src, sink)
        except BaseException as e:
            result["error"] = e

    cx = threading.Thread(target=compute)
    cx.start()

    # second reader: raw-baseband spill to disk, concurrent with compute
    # (the dada_dbdisk tap of the reference topology; the ring was
    # created with NREADER=2 so the writer waits on the slower of the
    # two readers, exactly like dada_db -r 2)
    spill_info = {}
    sx = None
    if args.spill:
        def spill():
            import os

            ring = rb.RingBuffer(key)
            n = 0
            try:
                ring.lock_read()
                hdr = ring.read_header()
                from ..io.dada import DadaFileWriter

                path = os.path.join(args.spill,
                                    f"{hdr.get('UTC_START', 'soak')}.dada")
                with DadaFileWriter(path, hdr) as w:
                    while True:
                        view = ring.open_block_read()
                        if view is None:
                            break
                        w.write(view.tobytes())
                        ring.close_block_read()
                        n += 1
                spill_info["path"] = path
            except Exception as e:
                # a dead tap must be diagnosable in the report, not just
                # a blocks_spilled shortfall with a stderr traceback
                spill_info["error"] = f"{type(e).__name__}: {e}"
            finally:
                spill_info["blocks"] = n
                ring.disconnect()   # releases the reader lock too

        sx = threading.Thread(target=spill)
        sx.start()

    t_start = time.perf_counter()
    tx.start()
    tx.join()
    stream_elapsed = time.perf_counter() - t_start
    eng.wait()
    cx.join()
    if sx is not None:
        sx.join()
    if "error" in result:
        raise RuntimeError("the compute stage failed") from result["error"]
    stats = result["stats"]

    port_stats = eng.port_stats()
    total_recv = sum(s.received for s in port_stats)
    total_exp = sum(s.expected for s in port_stats)
    loss = max(0.0, 1 - total_recv / total_exp) if total_exp else 1.0
    expected_blocks = total_frames // args.ndf
    report = {
        "backend": str(pipe.device),
        "mode": "+".join(
            ([f"pfb{args.pfb}"] if args.pfb else [])
            + (["stokes"] if args.stokes else [])
            + ([f"waterfall[{args.nspectra}]"] if args.nspectra > 1 else [])
            or ["power"])
            + ("  [device-layout rows]" if args.device_layout else "")
            + ("  [spill tap NREADER=2]" if args.spill else ""),
        "seconds": args.seconds,
        "rate_x_realtime": args.rate,
        "sender": args.sender,
        "frames_streamed": total_frames * args.nchk,
        "stream_elapsed": stream_elapsed,
        "loss": loss,
        "blocks_captured": int(eng.blocks_committed),
        "blocks_computed": stats.nblocks,
        "expected_blocks": expected_blocks,
        "force_switches": int(eng.force_switches),
        "warmup_sec": warmup_sec,
        "compute_realtime_x": stats.realtime_fraction,
        "kernel_launches": stats.kernel_launches,
        "pass": bool(loss <= args.max_loss
                     and stats.nblocks >= expected_blocks - 1),
    }
    if args.spill:
        report["blocks_spilled"] = spill_info.get("blocks", 0)
        report["spill_path"] = spill_info.get("path")
        if "error" in spill_info:
            report["spill_error"] = spill_info["error"]
        report["pass"] = bool(
            report["pass"] and "error" not in spill_info
            and spill_info.get("blocks", 0) == int(eng.blocks_committed))
    return report


if __name__ == "__main__":
    sys.exit(main())
