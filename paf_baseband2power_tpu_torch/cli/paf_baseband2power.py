"""CLI: the compute stage on PyTorch and CUDA (reference parity:
``paf_baseband2power``).

Flags of the JAX package's CLI:
  -a  input: a .dada file, a ring key (``ring:KEY`` or a bare hex key),
      or ``synthetic[:N]``
  -b  output: a .dada file or ring key
  -c  directory for runtime logs
  -d  CUDA device ordinal
Modes: total power (default) or ``--stokes`` (I, Q, U, V records), either
one per channel or, with ``--pfb NFFT`` (``--ntap``, ``--window``), per
fine channel of a polyphase filterbank, the overlap-save carry kept on the
device across blocks; each with ``--nspectra`` spectra per block and
``--mean``, from wire or ``ORDER SERIES`` (rows) input.
``--platform {cuda,cpu}``: ``cuda`` (the default) runs the CUDA kernels and
fails without a GPU; ``cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

from .. import constants as C


def looks_like_ring_key(s: str) -> bool:
    """A bare hex key of at most 8 digits that names no file (the JAX
    package's CLI rule)."""
    try:
        int(s, 16)
    except ValueError:
        return False
    return len(s) <= 8 and not os.path.exists(s)


@contextlib.contextmanager
def profile_trace(log_dir: str | None, device: torch.device):
    """torch.profiler trace of the region, written to
    ``<log_dir>/trace.json`` (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paf_baseband2power",
        description="Detect baseband data with original channels and "
        "integrate the detected data in time (PyTorch/CUDA)",
    )
    ap.add_argument("-a", "--input", required=True,
                    help=".dada file, ring key, or synthetic[:NBLOCKS]")
    ap.add_argument("-b", "--output", required=True,
                    help="output .dada file or ring key")
    ap.add_argument("-c", "--dir", default=None, help="log directory")
    ap.add_argument("-d", "--device", type=int, default=0,
                    help="CUDA device ordinal")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the CUDA kernels (fails without a GPU); "
                    "cpu: their plain PyTorch versions")
    ap.add_argument("--ndf", type=int, default=C.NDF_BLK,
                    help="frames per block")
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC,
                    help="frequency chunks")
    ap.add_argument("--mean", action="store_true",
                    help="average instead of sum over the window")
    ap.add_argument("--nspectra", type=int, default=1, metavar="N",
                    help="output N spectra per block (sub-block "
                    "integration; N must divide the block's frame count)")
    ap.add_argument("--depth", type=int, default=2,
                    help="blocks in flight (ring NBLK analogue)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip building and running the kernels before "
                    "data flows")
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes detection (I,Q,U,V per channel; "
                    "NPOL 4 records) instead of total power")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="channelize with an NFFT-point polyphase "
                    "filterbank before detection (the CUDA kernel takes "
                    "powers of two 2..1024 with --ntap 1..8, torch.fft the "
                    "other shapes; ORDER SERIES input 128..1024, --ntap "
                    "1..8)")
    ap.add_argument("--ntap", type=int, default=4, help="PFB taps")
    ap.add_argument("--window", default="hamming",
                    choices=["hamming", "hanning", "rect"])
    ap.add_argument("--stats-json", action="store_true",
                    help="print run statistics as JSON")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace to DIR/trace.json")
    ap.add_argument("--debug", action="store_true",
                    help="per-block output validation + verbose logging")
    ap.add_argument("--device-layout", action="store_true",
                    help="input blocks are host-corner-turned series rows "
                    "(capture --device-layout); detected from the header's "
                    "ORDER SERIES field")
    ap.add_argument("--wait-sod", action="store_true",
                    help="ring input: start at the marked observation "
                    "boundary, discarding pre-SOD blocks")
    args = ap.parse_args(argv)

    if args.platform == "cuda":
        if not torch.cuda.is_available():
            ap.error("--platform cuda: no CUDA device is available "
                     "(--platform cpu runs the plain PyTorch path)")
        if args.device >= torch.cuda.device_count():
            # reference behavior: single-visible-device fixup
            # (paf_baseband2power.cu:87-90)
            args.device = 0
        device = torch.device("cuda", args.device)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")

    from ..io.dada import output_header
    from ..runtime.debug import set_debug
    from ..runtime.pipeline import (
        FileSink,
        FileSource,
        PowerPipeline,
        SyntheticSource,
    )

    # --- source -----------------------------------------------------------
    if args.input.startswith("synthetic"):
        if args.device_layout:
            ap.error("--device-layout needs a ring or recording whose "
                     "blocks were corner-turned by the capture engine; "
                     "the synthetic source yields wire-order blocks")
        n = int(args.input.split(":", 1)[1]) if ":" in args.input else 4
        source = SyntheticSource(n, ndf=args.ndf, nchk=args.nchk)
        in_header = None
    elif args.input.startswith("ring:") or looks_like_ring_key(args.input):
        from ..io.ringbuffer import RingSource

        key = args.input.split(":", 1)[1] \
            if args.input.startswith("ring:") else args.input
        source = RingSource(key, ndf=args.ndf, nchk=args.nchk,
                            wait_sod=args.wait_sod)
        in_header = source.header
        if (in_header or {}).get("ORDER") == "SERIES":
            args.device_layout = True
        if args.device_layout:
            source.set_layout("rows")
    else:
        source = FileSource(args.input, ndf=args.ndf, nchk=args.nchk,
                            layout="rows" if args.device_layout else None)
        in_header = source.header
        args.device_layout = source.layout == "rows"

    # the step for these flags, chosen before any output is opened; a mode
    # the step refuses is a usage error
    try:
        pipe = PowerPipeline(device, mean=args.mean, depth=args.depth,
                             log_dir=args.dir, nout=args.nspectra,
                             device_layout=args.device_layout,
                             stokes=args.stokes, pfb_nfft=args.pfb,
                             pfb_ntap=args.ntap, pfb_window=args.window)
    except ValueError as e:
        ap.error(str(e))

    # --- sink -------------------------------------------------------------
    hdr = output_header(
        utc_start=(in_header or {}).get("UTC_START", "unset"),
        picoseconds=(in_header or {}).get("PICOSECONDS", "unset"),
        freq=(in_header or {}).get("FREQ", "unset"),
        bw=(in_header or {}).get("BW", "unset"),
        nchan=args.nchk * C.NCHAN_CHK * (args.pfb or 1),
        tint_sec=args.ndf * C.TDF_SEC,   # = TINT at the standard 8192
    )
    if args.pfb:
        hdr["PFB_NFFT"] = str(args.pfb)
        hdr["PFB_NTAP"] = str(args.ntap)
        hdr["PFB_WINDOW"] = args.window
    if args.stokes:
        # full-Stokes records: 4 x nchan float32 per spectrum, I/Q/U/V rows
        hdr["NPOL"] = "4"
        hdr["STOKES"] = "IQUV"
    if args.nspectra > 1:
        # finer output cadence: TSAMP shrinks by the sub-integration factor
        hdr["TSAMP"] = str(float(hdr["TSAMP"]) / args.nspectra)
        hdr["NSBLK"] = str(args.nspectra)
    if args.output.startswith("ring:") or looks_like_ring_key(args.output):
        from ..io.ringbuffer import RingSink

        key = args.output.split(":", 1)[1] \
            if args.output.startswith("ring:") else args.output
        sink = RingSink(key, header=hdr)
    else:
        sink = FileSink(args.output, header=hdr)

    if args.debug:
        set_debug(True)
    if not args.no_warmup:
        pipe.warmup(args.ndf, args.nchk)
    with profile_trace(args.profile, device):
        stats = pipe.run(source, sink)
    if args.stats_json:
        print(json.dumps({
            "nblocks": stats.nblocks,
            "elapsed_sec": stats.elapsed,
            "samples_per_sec": stats.samples_per_sec,
            "realtime_x": stats.realtime_fraction,
            "kernel_launches": stats.kernel_launches,
            "partial_bytes": stats.partial_bytes,
            "pfb_stage_depths": stats.pfb_stage_depths,
            "pfb_fft_lane_stages": stats.pfb_fft_lane_stages,
            "slot_waits": stats.slot_waits,
            "record_waits": stats.record_waits,
            "direct_h2d": stats.direct_h2d,
            "device": str(device),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
