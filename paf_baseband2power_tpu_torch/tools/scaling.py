"""Weak-scaling benchmark: samples/s of the sharded power step at growing
world sizes.

The counterpart of the JAX package's ``benchmarks/scaling.py``: the
per-rank step of ``parallel/sharded.py:make_sharded_power_step`` at 1, 2,
4, ... ranks up to ``--ranks``, with the per-rank block held constant
(``--ndf-per-dev`` frames x 48 chunks, by default 8192: the production
block on every rank; the JAX script's default is 512), and each point's
throughput and efficiency against the one-rank point. Every rank draws
the whole block on its device from seed 0 (int16 in [-256, 256), as the
bench draws them; the JAX script draws ``synthetic_block`` on the host)
and keeps its shard; rank 0 keeps the whole for the check. Each
world size is its own process group, one process per rank, as
``parallel/selfcheck.py`` starts them: ``nccl`` while every rank has a
card of its own, else ``gloo`` (ranks sharing a card, or the CPU). A
point's time is the slowest rank's per call, after an untimed call and a
barrier, synchronized on its device; rank 0 then holds the gathered
output equal to the single-device kernel's on the whole block (exact
int64 sums), and the run fails otherwise.

Ranks that share one card (or the CPU's cores) split its time, so there
the classic efficiency is meaningless; ``total_throughput_ratio`` =
sps(N) / sps(1) is ~1.0 when sharding and collectives add nothing, and on
one card per rank it equals N x the weak-scaling efficiency.

    python -m paf_baseband2power_tpu_torch.tools.scaling [--ndf-per-dev 8192]
        [--iters 5] [--ranks N] [--out results.json]

Prints one JSON line per point (the JAX script's keys); ``--out`` also
writes the report with its header (``virtual_mesh``: the ranks share a
device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(args) -> dict | None:
    """One rank of one world size; rank 0 returns its samples/s and
    whether the output equals the single-device kernel's."""
    import torch.distributed as dist

    from .. import constants as C
    from ..ops import cuda_power as CP
    from ..parallel import sharded as S
    from ..parallel.distributed import init_distributed, rank_device
    from ..parallel.mesh import make_mesh
    from ..probes._common import make_block_2d

    init_distributed(args.backend)
    device = rank_device(args.platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    n = dist.get_world_size()
    mesh = make_mesh(n_time=n)
    block = make_block_2d(args.ndf_per_dev * n, device)
    step = S.make_sharded_power_step(mesh)
    x = S.shard_block(block, mesh, step.in_spec)
    if dist.get_rank() != 0:          # a view would keep the whole alive
        x, block = x.clone(), None
    step(x)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = step(x)
    _sync(device)
    dt = torch.tensor([(time.perf_counter() - t0) / args.iters],
                      dtype=torch.float64,
                      device=device if args.backend == "nccl" else "cpu")
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    got = S.gather(out, mesh, step.out_spec)
    result = None
    if dist.get_rank() == 0:
        want = CP.baseband2power_cuda(block)
        nsamp = block.shape[0] * C.NSAMP_DF * C.NCHAN * C.NPOL_SAMP
        result = {"samples_per_sec": nsamp / dt.item(),
                  "equal": torch.equal(got, want.cpu())}
    dist.barrier()
    dist.destroy_process_group()
    return result


def _backend_for(platform: str, ranks: int) -> str:
    """``nccl`` when each of ``ranks`` has a card of its own, else
    ``gloo``."""
    if platform == "cuda" and ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def build_parser() -> argparse.ArgumentParser:
    from ..probes._common import add_platform

    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.tools.scaling")
    ap.add_argument("--ndf-per-dev", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=5)
    add_platform(ap)
    ap.add_argument("--ranks", type=int, default=0,
                    help="the largest world size (default: every visible "
                    "card; 2 on the CPU)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    from ..parallel.distributed import spawn_ranks
    from ..probes._common import card, device_for

    ap = build_parser()
    args = ap.parse_args(argv)
    device = device_for(ap, args.platform)
    if args.rank is not None:
        result = rank_main(args)
        if result is not None:
            print(json.dumps(result))
        return 0

    cuda = device.type == "cuda"
    top = args.ranks or (torch.cuda.device_count() if cuda else 2)
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= top]
    base_argv = list(argv if argv is not None else sys.argv[1:])
    results, backends, ok = [], {}, True
    base = None
    for n in sizes:
        backends[n] = _backend_for(args.platform, n)
        outs = spawn_ranks(__spec__.name,
                           [*base_argv, "--backend", backends[n]], n,
                           args.timeout)
        for r, (rc, _, err) in enumerate(outs):
            if rc:
                print(f"{n} ranks: rank {r} exit code {rc}: {err[-3000:]}",
                      file=sys.stderr)
        if any(rc for rc, _, _ in outs):
            return 1
        point = json.loads(outs[0][1].strip().splitlines()[-1])
        if not point["equal"]:
            print(f"{n} ranks: the sharded step's output differs from the "
                  "single-device kernel's", file=sys.stderr)
            ok = False
        sps = point["samples_per_sec"]
        base = base or sps
        results.append({"devices": n, "samples_per_sec": sps,
                        "weak_scaling_eff": sps / (base * n),
                        "total_throughput_ratio": sps / base})
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        report = {
            "backend": args.platform,
            "device": card(device),
            "dist_backend": backends,
            "physical_cores": len(os.sched_getaffinity(0)),
            "virtual_mesh": not cuda or top > torch.cuda.device_count(),
            "ndf_per_device": args.ndf_per_dev,
            "points": results,
        }
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
