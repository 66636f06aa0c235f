"""CLI: the multi-host (multi-rank) pipeline.

One instance runs per rank, one rank per device. Bootstrap is env-driven
(cluster launchers):
  PAFB2P_COORDINATOR  host:port of rank 0's store
  PAFB2P_NUM_PROCS    total processes
  PAFB2P_PROC_ID      this process's rank
  PAFB2P_LOCAL_RANK   its index on its host (the card it drives)
(unset -> a single process.)

Each rank feeds only its owned (beam, frame, chunk) slice — from a local
ring buffer (the capture engine's output), from recordings (one ``.dada``
file per beam, each rank reading its own bytes), or from the deterministic
synthetic feeder — runs the CUDA kernels on its device, and rank 0 sinks
the gathered spectra. This is the reference's share-nothing per-node
deployment (capture.c:570-584) re-expressed as one job; see
``runtime/multihost.py``. A port of the JAX package's ``paf_multihost``
without its ``--fetch-every``.

``--platform cuda`` (the default) exits 2 without a GPU; ``--platform cpu``
runs the plain PyTorch versions. ``--dist-backend``: ``nccl`` (the default
on ``cuda``) needs a GPU per rank; ranks that share one card use ``gloo``
(the default on ``cpu``), which stages the collectives' payloads through
host memory. Run, e.g., two CPU ranks:

    PAFB2P_COORDINATOR=127.0.0.1:29500 PAFB2P_NUM_PROCS=2 PAFB2P_PROC_ID=0 \\
        python -m paf_baseband2power_tpu_torch.cli.paf_multihost \\
        -a synthetic:3 -b out.dada --platform cpu &
    (the same with PAFB2P_PROC_ID=1 and no -b)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="paf_multihost")
    ap.add_argument("-a", "--input", default="synthetic:4",
                    help="synthetic[:N], ring:<key>, or recordings "
                    "PATH[,PATH...] (one .dada per beam) — the local "
                    "slice feeder")
    ap.add_argument("-b", "--output", default=None,
                    help="rank-0 output .dada power file")
    ap.add_argument("-c", "--dir", default=None, help="log directory")
    ap.add_argument("--nbeam", type=int, default=1, help="total beams")
    ap.add_argument("--ndf", type=int, default=64,
                    help="frames per global block")
    ap.add_argument("--nchk", type=int, default=8, help="frequency chunks")
    ap.add_argument("--mean", action="store_true")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="fine-channelize (PFB) before detection; the "
                    "overlap-save halo crosses ranks")
    ap.add_argument("--ntap", type=int, default=4, help="PFB taps")
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes records (composes with --pfb)")
    ap.add_argument("--nspectra", type=int, default=1,
                    help="sub-block integration: N spectra per block "
                    "(composes with --pfb/--stokes)")
    ap.add_argument("--device-layout", action="store_true",
                    help="feed series-row (ORDER SERIES) blocks; beams "
                    "run data-parallel through the rows kernels with "
                    "zero collectives")
    ap.add_argument("--scatter-output", action="store_true",
                    help="reduce-scatter composed fine-channel spectra "
                    "over the time axis instead of all-reducing (half the "
                    "collective bytes of the waterfall reduction; needs "
                    "n_time | nspectra)")
    ap.add_argument("--wait-sod", action="store_true",
                    help="ring feeder: start at the marked observation "
                    "boundary, discarding pre-SOD blocks (mid-stream "
                    "attach; every rank must see the mark on its ring)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the CUDA kernels on this rank's card "
                    "(fails without a GPU); cpu: their plain versions")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="process-group backend (default nccl on cuda, "
                    "gloo on cpu); ranks sharing one card need gloo")
    ap.add_argument("--stats-json", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available "
                 "(--platform cpu runs the plain PyTorch path)")
    backend = args.dist_backend or ("nccl" if args.platform == "cuda"
                                    else "gloo")
    if args.platform == "cpu" and backend == "nccl":
        ap.error("--dist-backend nccl needs --platform cuda")

    import torch.distributed as dist

    from ..ops import cuda_power as CP
    from ..parallel.distributed import check_backend
    from ..parallel.mesh import mesh_shape
    from ..runtime.multihost import MultihostRunner
    from ..runtime.pipeline import FileSink, MemorySink

    try:
        check_backend(backend)
    except ValueError as e:
        ap.error(str(e))
    runner = MultihostRunner(nbeam_total=args.nbeam, ndf=args.ndf,
                             nchk=args.nchk, mean=args.mean,
                             log_dir=args.dir, pfb_nfft=args.pfb,
                             pfb_ntap=args.ntap, stokes=args.stokes,
                             nout=args.nspectra,
                             device_layout=args.device_layout,
                             scatter_output=args.scatter_output,
                             platform=args.platform, backend=backend)
    setup_sec = time.perf_counter() - t_start
    try:
        source = _source(args, runner)
        sink = None
        if dist.get_rank() == 0:
            sink = FileSink(args.output) if args.output else MemorySink()
        launches0 = dict(CP.launches)
        stats = runner.run(source, sink)
    finally:
        dist.destroy_process_group()

    if args.stats_json:
        print(json.dumps({
            "process": runner.rank,
            "nprocs": runner.world,
            "backend": runner.backend,
            "device": str(runner.device),
            "mesh": mesh_shape(runner.mesh),
            "setup_sec": setup_sec,
            "nblocks": stats.nblocks,
            "elapsed": stats.elapsed,
            "realtime_x": stats.realtime_fraction,
            "kernel_launches": stats.kernel_launches,
            "launches": {k: v - launches0.get(k, 0)
                         for k, v in CP.launches.items()
                         if v - launches0.get(k, 0)},
        }))
    return 0


def _source(args, runner):
    """This rank's slice feeder for ``-a``."""
    from ..runtime.multihost import file_local_source, synthetic_local_source

    if args.input.startswith("synthetic"):
        n = int(args.input.split(":", 1)[1]) if ":" in args.input else 4
        return synthetic_local_source(runner, n, seed=args.seed)
    if not args.input.startswith("ring:"):
        try:
            return file_local_source(runner, args.input.split(","))
        except (OSError, ValueError) as e:
            raise SystemExit(str(e))

    from ..io.ringbuffer import RingSource

    key = args.input.split(":", 1)[1]
    if runner.local_shape[0] != 1:
        raise SystemExit("ring feeder supports one local beam per rank")
    nchk_l = runner.slice[2][1] - runner.slice[2][0]
    if args.device_layout:
        nbeam_l, nseries, ndf_l, seg = runner.local_shape
        ring = RingSource(key, ndf=ndf_l, nchk=nchk_l, layout="rows",
                          wait_sod=args.wait_sod)
        source = (blk.reshape(1, nseries, ndf_l, seg) for blk in ring)
    else:
        nbeam_l, ndf_l, lanes = runner.local_shape
        ring = RingSource(key, ndf=ndf_l, nchk=nchk_l,
                          wait_sod=args.wait_sod)
        source = (blk.reshape(1, ndf_l, -1) for blk in ring)
    # layout mismatch = silently transposed garbage; the runner's step is
    # already built for args.device_layout, so unlike paf_baseband2power
    # (which auto-adopts the header) this must reject the contradiction
    # outright
    ring_order = (ring.header or {}).get("ORDER")
    if args.device_layout != (ring_order == "SERIES"):
        raise SystemExit(
            f"ring '{key}' holds ORDER={ring_order or 'TF'} blocks "
            f"but --device-layout={'on' if args.device_layout else 'off'}"
            " — pass the flag matching the capture layout")
    return source


if __name__ == "__main__":
    sys.exit(main())
