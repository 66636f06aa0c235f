"""Check the per-rank steps of ``parallel/sharded.py`` across real devices.

Starts one process per rank (``PAFB2P_*`` bootstrap on a free localhost
port; rank ``r`` drives card ``r``, or the CPU). Every rank draws the same
global int16 blocks on its device from a seed, takes its shard, runs each
case's step, and rank 0 gathers the output and holds it against the
single-device kernel on the whole block: power and Stokes bit-equal, the
PFB within 2e-5 peak-normalized. Each case's time per block, after one
untimed call and from a barrier, is the slowest rank's, synchronized on
its device (the collectives included), beside the single-device
kernel's on rank 0. Prints one JSON line; exits
non-zero if a case disagrees or a rank fails.

    python -m paf_baseband2power_tpu_torch.parallel.selfcheck --ranks 4
    python -m paf_baseband2power_tpu_torch.parallel.selfcheck --ranks 2 \\
        --platform cpu --ndf 64 --nchk 4 --nfft 32

``--backend`` defaults to ``nccl`` on ``cuda`` (a card per rank) and
``gloo`` on ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.distributed as dist

from .distributed import spawn_ranks

BOUND_PFB = 2e-5


def _cases(world: int, nfft: int):
    """(name, mesh, factory, kwargs, layout, blocks, beams): the meshes
    use every rank; ``blocks`` > 1 streams with the carry."""
    half = (2, world // 2) if world % 2 == 0 and world > 2 else (world, 1)
    beams = 2 if world % 2 == 0 else 1
    return [
        ("power, time-sharded", ("tc", world, 1), "make_sharded_power_step",
         {}, "wire", 1, 0),
        ("Stokes, time x chunk", ("tc",) + half, "make_sharded_stokes_step",
         {}, "wire", 1, 0),
        ("power x 8 spectra, time-sharded", ("tc", world, 1),
         "make_sharded_scrunch_step", {"nout": 8 * world}, "wire", 1, 0),
        (f"PFB {nfft} Stokes x 8, time-sharded, streaming",
         ("tc", world, 1), "make_sharded_spectra_step",
         {"nfft": nfft, "nout": 8, "stokes": True, "streaming": True},
         "wire", 2, 0),
        (f"PFB {nfft} Stokes x 8, scatter_output", ("tc", world, 1),
         "make_sharded_spectra_step",
         {"nfft": nfft, "nout": 8, "stokes": True, "scatter_output": True},
         "wire", 1, 0),
        (f"PFB {nfft} power, time x chunk, streaming", ("tc",) + half,
         "make_sharded_pfb_step", {"nfft": nfft, "streaming": True}, "wire",
         2, 0),
        ("power, beam x time", ("btc", beams, world // beams, 1),
         "make_multibeam_power_step_2d", {}, "wire", 1, beams),
        ("rows PFB 128, series-sharded, streaming", ("tc", 1, world),
         "make_sharded_rows_step", {"nfft": 128, "streaming": True},
         "rows", 2, 0),
    ]


def _reference(x, factory: str, kw: dict, layout: str, history):
    """The single-device kernel (or plain version on the CPU) on the whole
    block; returns ``(out, new_history)``."""
    from ..ops import cuda_pfb as CPF
    from ..ops import cuda_power as CP

    if factory == "make_sharded_power_step":
        return CP.baseband2power_cuda(x), None
    if factory == "make_sharded_stokes_step":
        return CP.baseband2stokes_cuda(x), None
    if factory == "make_sharded_scrunch_step":
        return CP.baseband2power_scrunch_cuda(x, kw["nout"]), None
    if factory == "make_multibeam_power_step_2d":
        return torch.stack([CP.baseband2power_cuda(b) for b in x]), None
    opts = {k: v for k, v in kw.items() if k in ("nout", "stokes")}
    out, h = CPF.pfb_spectra_cuda(x, kw["nfft"], history=history,
                                  return_history=True, layout=layout, **opts)
    return (out if factory != "make_sharded_pfb_step" else out[0]), h


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rank_main(args) -> dict | None:
    """One rank: every case; rank 0 returns the report."""
    from ..constants import DT_SIZE, NCHAN_CHK, NPOL_SAMP, NSAMP_DF
    from . import mesh as M
    from . import sharded as S
    from .distributed import init_distributed, rank_device

    init_distributed(args.backend)
    device = rank_device(args.platform)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    report = []
    meshes = {}
    for case, (name, mspec, factory, kw, layout, nblocks, beams) in \
            enumerate(_cases(world, args.nfft)):
        if mspec not in meshes:
            meshes[mspec] = (M.make_mesh(*mspec[1:]) if mspec[0] == "tc"
                             else M.make_beam_mesh(*mspec[1:]))
        mesh = meshes[mspec]
        step = getattr(S, factory)(mesh, **kw)
        shape = ((args.nchk * NCHAN_CHK * NPOL_SAMP, args.ndf,
                  2 * NSAMP_DF) if layout == "rows"
                 else (args.ndf, args.nchk * DT_SIZE // 2))
        if beams:
            shape = (beams,) + shape
        gen = torch.Generator(device=device)

        def draw(i):
            gen.manual_seed(args.seed + 100 * case + i)
            x = torch.randint(-32768, 32768, shape, dtype=torch.int16,
                              device=device, generator=gen)
            return x, S.shard_block(x, mesh, step.in_spec)

        # an untimed call first: the first use of a group or a peer sets up
        # its communicator, and the first launch loads the kernels
        x, shard = draw(0)
        out = step(shard, None)[0] if kw.get("streaming") else step(shard)
        S.gather(out, mesh, step.out_spec)
        if rank == 0:
            _reference(x, factory, kw, layout, None)
        h = ref_h = None
        times, err, equal = [], 0.0, True
        single = []
        for i in range(nblocks):
            x, shard = draw(i)
            # start together: rank 0 checks the previous block alone, and
            # a collective would count the others' wait for it
            _sync(device)
            dist.barrier()
            t0 = time.perf_counter()
            if kw.get("streaming"):
                out, h = step(shard, h)
            else:
                out = step(shard)
            _sync(device)
            times.append(time.perf_counter() - t0)
            got = S.gather(out, mesh, step.out_spec)
            if rank == 0:
                _sync(device)
                t0 = time.perf_counter()
                want, ref_h = _reference(x, factory, kw, layout, ref_h)
                _sync(device)
                single.append(time.perf_counter() - t0)
                want = want.cpu()
                if "nfft" in kw:
                    d = (got.double() - want.double()).abs().max().item()
                    err = max(err, d / want.double().abs().max().item())
                else:
                    equal = equal and torch.equal(got, want)
            del x, shard
        # the slowest rank's time per block
        worst = torch.tensor(times, dtype=torch.float64,
                             device=device if args.backend == "nccl"
                             else "cpu")
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        if rank == 0:
            exact = "nfft" not in kw
            report.append({
                "case": name, "mesh": M.mesh_shape(mesh),
                "ok": bool(equal if exact else err < BOUND_PFB),
                "bit_equal" if exact else "max_err_peak_normalized":
                    equal if exact else err,
                "ms_per_block": [1e3 * t for t in worst.tolist()],
                "single_device_ms": [1e3 * t for t in single]})
    dist.barrier()
    dist.destroy_process_group()
    return report if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="selfcheck")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks (default: every visible card)")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--ndf", type=int, default=8192)
    ap.add_argument("--nchk", type=int, default=48)
    ap.add_argument("--nfft", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.platform == "cuda" and not torch.cuda.is_available():
        ap.error("--platform cuda: no CUDA device is available")
    args.backend = args.backend or ("nccl" if args.platform == "cuda"
                                    else "gloo")
    if args.rank is not None:
        report = rank_main(args)
        if report is not None:
            print(json.dumps(report))
        return 0
    ranks = args.ranks or (torch.cuda.device_count()
                           if args.platform == "cuda" else 2)
    outs = spawn_ranks(__spec__.name, [*(argv or sys.argv[1:]), "--backend",
                                       args.backend], ranks, args.timeout)
    failed = [(r, rc, e[-2000:]) for r, (rc, _, e) in enumerate(outs) if rc]
    report = (json.loads(outs[0][1].strip().splitlines()[-1])
              if not failed else [])
    print(json.dumps({
        "device": {"platform": "gpu" if args.platform == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if args.platform == "cuda" else "cpu"),
                   "count": (torch.cuda.device_count()
                             if args.platform == "cuda" else 0)},
        "ranks": ranks, "backend": args.backend, "ndf": args.ndf,
        "nchk": args.nchk, "cases": report, "failed_ranks": failed}))
    return 0 if report and not failed and all(c["ok"] for c in report) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
