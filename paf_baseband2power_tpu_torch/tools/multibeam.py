"""Multibeam overlap benchmark: B beams through one mesh of ranks vs B x
the single-beam pipeline.

The counterpart of the JAX package's ``benchmarks/multibeam.py`` (its
criterion: the multibeam runtime stays within ~20% of single-beam
throughput x B, per-beam data volume held constant), on the port's
``runtime/multibeam.run_multibeam`` and ``runtime/pipeline.PowerPipeline``.
One process per rank, as ``parallel/selfcheck.py`` starts them. Each beam's
blocks are drawn on the rank's device from a seed (int16 in [-256, 256),
as the bench draws them) before anything is timed and held in host
memory, where a capture ring would hold them; rank 0 holds every beam's,
the other ranks their own. (The JAX script draws ``synthetic_block`` in
its timed loops, so at the production block it would time numpy's
generator.) Rank 0 first runs the B beams one after another through one
``PowerPipeline`` on its device (the serial baseline), then every rank
runs the multibeam step over the ``(beam, time, chunk)`` mesh, once to
warm it and once timed. Every multibeam record must equal the serial
pipeline's (both are exact int64 sums): the run fails otherwise. Prints
one JSON line with the JAX script's keys. The defaults are the production
block, 8192 x 48 (2.8 GB), 3 per beam; the JAX script's are 256 x 8, 16
per beam.

    python -m paf_baseband2power_tpu_torch.tools.multibeam [--ndf 8192] \\
        [--nchk 48] [--nblocks 3] [--nbeam 2]
    ... --ranks 2 --backend gloo        # two ranks sharing one card
    ... --platform cpu --ranks 2 --ndf 16 --nchk 8   # gloo ranks, CPU

``--ranks`` defaults to every visible card (``--nbeam`` on the CPU);
``--backend`` to ``nccl`` when every rank has a card of its own, else
``gloo``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _mesh_dims(n: int, nbeam: int) -> tuple[int, int, int]:
    """``(nbeam, n_time, n_chunk)`` over ``n`` ranks, as the JAX script
    lays its devices out."""
    n_time = max(1, n // (nbeam * 2))
    return nbeam, n_time, n // (nbeam * n_time)


def rank_main(args) -> tuple[dict, bool] | None:
    """One rank; rank 0 returns the report and whether every multibeam
    record equals the serial pipeline's."""
    import torch.distributed as dist

    from ..parallel import mesh as M
    from ..parallel.distributed import init_distributed, rank_device
    from ..probes._common import make_block_2d
    from ..runtime import pipeline as RP
    from ..runtime.multibeam import run_multibeam

    init_distributed(args.backend)
    device = rank_device(args.platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    nbeam = args.nbeam
    mesh = M.make_beam_mesh(*_mesh_dims(dist.get_world_size(), nbeam))
    mine = M.axis_index(mesh, M.BEAM_AXIS)
    beams = [[make_block_2d(args.ndf, device, seed=100 * b + i,
                            nchk=args.nchk).cpu().numpy()
              for i in range(args.nblocks)] if rank == 0 or b == mine
             else [] for b in range(nbeam)]

    # single-beam baseline: one PowerPipeline, the beams run serially
    serial = [RP.MemorySink() for _ in range(nbeam)]
    if rank == 0:
        pipe = RP.PowerPipeline(device, depth=4)
        pipe.warmup(args.ndf, args.nchk)
        t0 = time.perf_counter()
        for blocks, sink in zip(beams, serial):
            pipe.run(blocks, sink)
        t_single = time.perf_counter() - t0
    dist.barrier()

    # multibeam: one step over the (beam, time, chunk) mesh
    run_multibeam(beams, mesh, [RP.MemorySink() for _ in range(nbeam)],
                  device=device)       # warm the kernels and the groups
    sinks = [RP.MemorySink() for _ in range(nbeam)]
    dist.barrier()
    t0 = time.perf_counter()
    stats = run_multibeam(beams, mesh, sinks, device=device)
    t_multi = time.perf_counter() - t0
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return None
    equal = all(len(a.records) == len(b.records) == args.nblocks
                and all(np.array_equal(x, y)
                        for x, y in zip(a.records, b.records))
                for a, b in zip(sinks, serial))
    ratio = t_single / t_multi  # >1: multibeam beats serial per-beam
    return {
        "nbeam": nbeam, "mesh": M.mesh_shape(mesh),
        "nblocks_per_beam": args.nblocks,
        "serial_per_beam_sec": t_single,
        "multibeam_sec": t_multi,
        "speedup_vs_serial": ratio,
        "within_20pct_of_serial": bool(ratio >= 0.8),
        "blocks": stats.nblocks,
    }, equal


def build_parser() -> argparse.ArgumentParser:
    from .. import constants as C
    from ..probes._common import add_platform

    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.multibeam")
    ap.add_argument("--ndf", type=int, default=C.NDF_BLK)
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC)
    ap.add_argument("--nblocks", type=int, default=3)
    ap.add_argument("--nbeam", type=int, default=2)
    add_platform(ap)
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks (default: every visible card; --nbeam on "
                    "the CPU)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    from ..parallel.distributed import spawn_ranks

    ap = build_parser()
    args = ap.parse_args(argv)
    cuda = args.platform == "cuda"
    if cuda and not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available "
                 "(--platform cpu runs the plain PyTorch versions)")
    ranks = args.ranks or (torch.cuda.device_count() if cuda else args.nbeam)
    if ranks % args.nbeam:
        ap.error(f"{ranks} ranks do not split into {args.nbeam} beams")
    args.backend = args.backend or (
        "nccl" if cuda and ranks <= torch.cuda.device_count() else "gloo")
    if args.rank is not None:
        out = rank_main(args)
        if out is not None:
            report, equal = out
            print(json.dumps(report))
            if not equal:
                print("multibeam records differ from the serial pipeline's",
                      file=sys.stderr)
                return 1
        return 0
    outs = spawn_ranks(__spec__.name,
                       [*(argv if argv is not None else sys.argv[1:]),
                        "--ranks", str(ranks), "--backend", args.backend],
                       ranks, args.timeout)
    for r, (rc, _, err) in enumerate(outs):
        if rc:
            print(f"rank {r} exit code {rc}: {err[-3000:]}", file=sys.stderr)
    lines = outs[0][1].strip().splitlines()
    if lines:
        print(lines[-1], flush=True)
    return 0 if lines and not any(rc for rc, _, _ in outs) else 1


if __name__ == "__main__":
    sys.exit(main())
