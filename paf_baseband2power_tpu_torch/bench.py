"""Benchmark: baseband -> power throughput on one card (the counterpart of
the repository's root ``bench.py``, on the port's CUDA kernels).

    python -m paf_baseband2power_tpu_torch.bench         # the 10-mode matrix
    ... bench --single       # direct power only
    ... bench --pfb 1024 --device-layout --stokes --scrunch 8
    ... bench --h2d          # host -> device copy of a block
    ... bench --e2e          # PowerPipeline, end to end
    ... bench --platform cpu --quick

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline", ...,
"device"}``.

Metric: complex baseband samples/s through unpack -> detect -> integrate
of real-geometry blocks (8192 frames x 48 chunks x 336 channels x 2 pols =
704,643,072 complex samples, 2.8 GB per block; ``--quick``: 256 frames),
drawn on the device from a seed (int16 in [-256, 256)) so that the kernel,
not the host link, is timed. Time per block is the two-point slope of
back-to-back calls on the card's clock (CUDA events; the host's clock on
the CPU), the best of 3 at each point. Baseline: the reference's hard
real-time requirement, 796.4 Msamp/s per node (``BASELINE.md``);
``vs_baseline`` is how many real-time streams one card sustains.
``hbm_fraction``: the block's bytes over the time per block, as a fraction
of the H100's 3.35 TB/s (``h100.HBM_BPS``); absent (null) on the CPU.

``--platform cuda`` (the default) fails without a CUDA device; every mode
then runs its CUDA wrapper (``ops/cuda_power.py``, ``ops/cuda_pfb.py``),
and a build or launch failure ends the run. A ``--pfb`` shape the kernel
does not take (``cuda_pfb.kernel_refuses``) runs through torch.fft on the
card, as ``PowerPipeline`` routes it, and the label says so.
``--platform cpu`` runs the plain PyTorch versions. ``--impl torch`` runs
the plain versions on the chosen device. No path falls back to another:
on ``cuda`` a mode that launched no kernel is an error. Every line names
what ran (``cuda``, ``torch cpu``, ``torch cuda``) and the card
(``nvidia-smi``'s name and power limit).

``--h2d``: host -> device copy of a full block from pageable numpy memory
(the JAX bench's metric) and from pinned memory, against the capture
line rate of 3.19 GB/s. ``--e2e``: the port's ``PowerPipeline`` (pinned
staging, H2D on a copy stream, kernel, D2H; ``depth`` 2) over host blocks
in memory, as a multiple of real time.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from . import constants as C
from .h100 import HBM_BPS
from .ops import cuda_pfb as CF
from .ops import cuda_power as CP
from .ops import pfb as PF
from .ops import power as P
from .probes._common import add_platform, describe, device_for, slope, timer

BASELINE_SAMPLES_PER_SEC = 796.4e6  # 336 chan * 2 pol * 1.185185 Msamp/s
H2D_BASELINE_BPS = 3.19e9           # capture line rate (capture.h:28,30)
NTAP = 4                            # PFB taps in every bench mode
QUICK_NDF = 256


def make_block_2d(ndf: int, device: torch.device, seed: int = 0,
                  nchk: int = C.NCHK_NIC) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584)`` int16 in [-256, 256), drawn on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-256, 256, (ndf, nchk * P.LANES_PER_CHUNK),
                         dtype=torch.int16, device=device, generator=gen)


def make_block_rows(ndf: int, device: torch.device, seed: int = 0,
                    nchk: int = C.NCHK_NIC) -> torch.Tensor:
    """Series rows ``(nchk * 14, ndf, 256)`` int16 in [-256, 256), as the
    capture engine's device-layout mode delivers them, drawn on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nseries = nchk * C.NCHAN_CHK * C.NPOL_SAMP
    return torch.randint(-256, 256, (nseries, ndf, P.ROW_LANES),
                         dtype=torch.int16, device=device, generator=gen)


@dataclasses.dataclass(frozen=True)
class Ops:
    """One family of detection functions with the plain versions'
    signatures, and the name of what runs them."""
    label: str
    power: Callable
    power_scrunch: Callable
    power_rows: Callable
    stokes: Callable
    stokes_scrunch: Callable
    stokes_rows: Callable
    pfb_spectra: Callable
    pfb_power: Callable


def ops_for(impl: str, device: torch.device) -> Ops:
    """``cuda``: the CUDA wrappers; ``torch``: the plain versions, on
    ``device``."""
    if impl == "cuda":
        return Ops("cuda", CP.baseband2power_cuda,
                   CP.baseband2power_scrunch_cuda,
                   CP.baseband2power_scrunch_rows_cuda,
                   CP.baseband2stokes_cuda, CP.baseband2stokes_scrunch_cuda,
                   CP.baseband2stokes_scrunch_rows_cuda, CF.pfb_spectra_cuda,
                   CF.pfb_power_cuda)
    return Ops(f"torch {device.type}", P.baseband2power_2d,
               P.baseband2power_scrunch_2d, P.baseband2power_scrunch_rows,
               P.baseband2stokes_2d, P.baseband2stokes_scrunch_2d,
               P.baseband2stokes_scrunch_rows, PF.pfb_spectra, PF.pfb_power)


def pfb_route(ops: Ops, nfft: int) -> tuple[Callable, Callable, str]:
    """``(spectra, power, route)`` for ``nfft`` at ``NTAP`` taps: on the
    CUDA wrappers, the kernel where it takes the shape, else torch.fft on
    the card (``PowerPipeline``'s rule); otherwise ``ops``' own."""
    if ops.label != "cuda":
        return ops.pfb_spectra, ops.pfb_power, ops.label
    why = CF.kernel_refuses(nfft, NTAP)
    if why is None:
        return ops.pfb_spectra, ops.pfb_power, "cuda"
    return CF.pfb_spectra_torch, CF.pfb_power_torch, f"torch.fft: {why}"


def carried(step2: Callable) -> Callable:
    """``step(block)`` of a streaming ``step2(block, carry) -> (out,
    carry)`` (``ops/pfb.py``'s factories), holding the carry between
    calls."""
    carry = None

    def step(block):
        nonlocal carry
        out, carry = step2(block, carry)
        return out

    return step


def pfb_rows(spectra: Callable, nfft: int, **kw) -> Callable:
    """A streaming PFB step on series rows through ``spectra``."""
    return carried(PF.make_streaming_spectra(nfft, NTAP, spectra=spectra,
                                             layout="rows", **kw))


# the root bench's matrix (``bench_matrix``), mode by mode: name, layout,
# step factory
MATRIX = [
    ("power", "wire", lambda o: o.power),
    ("power rows", "rows", lambda o: lambda b: o.power_rows(b, 1)),
    ("stokes", "wire", lambda o: o.stokes),
    ("scrunch[64]", "wire", lambda o: lambda b: o.power_scrunch(b, 64)),
    ("stokes x scrunch[64]", "wire",
     lambda o: lambda b: o.stokes_scrunch(b, 64)),
    ("stokes rows", "rows", lambda o: lambda b: o.stokes_rows(b, 1)),
    ("stokes x scrunch[64] rows", "rows",
     lambda o: lambda b: o.stokes_rows(b, 64)),
    ("pfb 128 rows streaming", "rows",
     lambda o: pfb_rows(o.pfb_spectra, 128)),
    ("pfb 128 x stokes rows streaming", "rows",
     lambda o: pfb_rows(o.pfb_spectra, 128, stokes=True)),
    ("pfb 1024 rows streaming", "rows",
     lambda o: pfb_rows(o.pfb_spectra, 1024)),
]


def single_step(args, ops: Ops) -> tuple[str, str, Callable]:
    """``(label, layout, step)`` of the mode the flags name (the root
    bench's single modes, in its order)."""
    nout = args.scrunch or 1
    compose = ((" x stokes" if args.stokes else "")
               + (f" x nout={nout}" if nout > 1 else ""))
    if args.pfb and args.device_layout:
        # series rows: the capture engine's device-layout blocks, every
        # composition on the kernel's rows path
        spectra, _, route = pfb_route(ops, args.pfb)
        return (f"pfb nfft={args.pfb} [device-layout rows]{compose} "
                f"[{route}]", "rows",
                pfb_rows(spectra, args.pfb, nout=nout, stokes=args.stokes))
    if args.pfb and (args.stokes or args.scrunch):
        spectra, _, route = pfb_route(ops, args.pfb)
        return (f"pfb nfft={args.pfb}{compose} [{route}]", "wire",
                carried(PF.make_streaming_spectra(
                    args.pfb, NTAP, nout=nout, stokes=args.stokes,
                    spectra=spectra)))
    if args.stokes and args.scrunch:
        return (f"stokes x scrunch {ops.label} nout={nout}", "wire",
                lambda b: ops.stokes_scrunch(b, nout))
    if args.stokes:
        return f"stokes {ops.label}", "wire", ops.stokes
    if args.scrunch:
        return (f"scrunch {ops.label} nout={nout}", "wire",
                lambda b: ops.power_scrunch(b, nout))
    if args.pfb:
        _, power, route = pfb_route(ops, args.pfb)
        return (f"pfb nfft={args.pfb} [{route}]", "wire",
                carried(PF.make_streaming_pfb(args.pfb, NTAP, power=power)))
    return ops.label, "wire", ops.power


def measure(step: Callable, block: torch.Tensor, n1: int, n2: int,
            repeats: int = 3) -> tuple[float, dict]:
    """Seconds per call of ``step(block)`` (two warm-up calls: the build,
    and a streaming step's carry; then the two-point slope) and the kernel
    launches of the timed calls by wrapper."""
    step(block)
    step(block)
    before = collections.Counter(CP.launches)
    dt = slope(timer(lambda: step(block), block.device), n1, n2, repeats)
    counts = collections.Counter(CP.launches)
    counts.subtract(before)
    return dt, {k: v for k, v in sorted(counts.items()) if v > 0}


def rates(what: str, dt: float, block: torch.Tensor, ops: Ops,
          launched: dict) -> dict:
    """Per-block figures of one timed mode; raises if the CUDA wrappers
    launched no kernel."""
    ndf = block.shape[1] if block.ndim == 3 else block.shape[0]
    nchk = block.numel() // (ndf * P.LANES_PER_CHUNK)
    samples = ndf * C.NSAMP_DF * nchk * C.NCHAN_CHK * C.NPOL_SAMP
    launches = sum(launched.values())
    if ops.label == "cuda" and not launches:
        raise RuntimeError(f"{what}: no CUDA kernel launched")
    return {
        "block_ms": dt * 1e3,
        "x_realtime": ndf * C.TDF_SEC / dt,
        "samples_per_sec": samples / dt,
        "hbm_fraction": (block.numel() * 2 / dt / HBM_BPS
                         if block.device.type == "cuda" else None),
        "launches": launches,
        "wrappers": launched,
    }


def card(device: torch.device) -> dict:
    """The device a line was measured on; for a card, also ``nvidia-smi``'s
    name and power limit."""
    out = describe(device)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
        out["nvidia_smi"] = "; ".join(smi.strip().splitlines())
    return out


def bench_matrix(ndf: int, iters: int, ops: Ops, device: torch.device,
                 nchk: int = C.NCHK_NIC) -> dict:
    """Every mode of ``MATRIX`` at ``ndf`` x ``nchk``, each timed as the
    root bench times its matrix; the headline is the first (direct
    power)."""
    blocks = {"wire": make_block_2d(ndf, device, nchk=nchk),
              "rows": make_block_rows(ndf, device, nchk=nchk)}
    n1 = max(2, iters // 6)
    matrix = []
    for name, layout, factory in MATRIX:
        dt, launched = measure(factory(ops), blocks[layout], n1, 3 * n1)
        matrix.append({"mode": name,
                       **rates(name, dt, blocks[layout], ops, launched)})
    head = matrix[0]
    return {
        "metric": "baseband samples/s/chip (unpack+detect+integrate, "
                  f"{ops.label})",
        "value": head["samples_per_sec"],
        "unit": "samples/s",
        "vs_baseline": head["samples_per_sec"] / BASELINE_SAMPLES_PER_SEC,
        "hbm_fraction": head["hbm_fraction"],
        "matrix": matrix,
        "device": card(device),
    }


def bench_single(args, ndf: int, ops: Ops, device: torch.device,
                 nchk: int = C.NCHK_NIC) -> dict:
    """The mode the flags name, timed as the root bench's single modes."""
    label, layout, step = single_step(args, ops)
    block = (make_block_rows if layout == "rows" else make_block_2d)(
        ndf, device, nchk=nchk)
    n1 = max(2, args.iters // 3)
    if args.quick or args.pfb:
        n1 = max(2, n1 // 4)
    dt, launched = measure(step, block, n1, 3 * n1)
    r = rates(label, dt, block, ops, launched)
    return {
        "metric": f"baseband samples/s/chip (unpack+detect+integrate, "
                  f"{label})",
        "value": r["samples_per_sec"],
        "unit": "samples/s",
        "vs_baseline": r["samples_per_sec"] / BASELINE_SAMPLES_PER_SEC,
        **{k: r[k] for k in ("block_ms", "hbm_fraction", "launches",
                             "wrappers")},
        "device": card(device),
    }


def host_block(ndf: int, seed: int = 0,
               nchk: int = C.NCHK_NIC) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -256, 256, size=(ndf, nchk * P.LANES_PER_CHUNK), dtype=np.int16)


def bench_h2d(ndf: int, iters: int, device: torch.device) -> dict:
    """The best of ``iters`` copies of a full host block to the card, from
    pageable numpy memory (``torch.from_numpy(host).to(device)``, the JAX
    bench's ``device_put``) and from one pinned tensor, each ended by a
    synchronize. The bar is the capture line rate, 3.19 GB/s."""
    host = host_block(ndf)
    nbytes = host.nbytes

    def best(src: torch.Tensor) -> float:
        times = []
        for _ in range(iters + 1):       # the first warms the allocator
            t0 = time.perf_counter()
            src.to(device, non_blocking=src.is_pinned())
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        return min(times[1:])

    pageable = best(torch.from_numpy(host))
    pinned = best(torch.from_numpy(host).pin_memory())
    return {
        "metric": "H2D bytes/s (full 2-D block, pageable numpy -> card)",
        "value": nbytes / pageable,
        "unit": "bytes/s",
        "vs_baseline": nbytes / pageable / H2D_BASELINE_BPS,
        "block_bytes": nbytes,
        "block_sec": pageable,
        "pinned_bytes_per_sec": nbytes / pinned,
        "pinned_block_sec": pinned,
        "pinned_vs_baseline": nbytes / pinned / H2D_BASELINE_BPS,
        "device": card(device),
    }


def mem_available() -> int:
    """The host's ``MemAvailable`` in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def bench_e2e(ndf: int, iters: int, ops: Ops, device: torch.device,
              depth: int = 2, nchk: int = C.NCHK_NIC) -> dict:
    """The port's ``PowerPipeline(device, depth)`` over a source that cycles
    3 distinct host blocks, into a ``MemorySink``; seconds per block by the
    two-point slope of whole runs of ``n1 = max(2, iters // 3)`` and ``3 *
    n1`` blocks (best of 2 each). The bar is real time, one block's stream
    seconds per block (``vs_baseline`` = stream time / wall time).
    ``wrappers``: the kernel launches of the timed runs by wrapper."""
    from .runtime.pipeline import MemorySink, PowerPipeline

    nhost = min(3, iters)
    need = (nhost + depth) * ndf * nchk * C.DT_SIZE
    avail = mem_available()
    print(f"bench --e2e: {nhost} host blocks and {depth} staging slots need "
          f"{need} B; MemAvailable {avail} B", file=sys.stderr, flush=True)
    if need > avail:
        raise RuntimeError(f"--e2e needs {need} B of host memory, "
                           f"{avail} B available")
    hosts = [host_block(ndf, seed, nchk) for seed in range(nhost)]
    pipe = PowerPipeline(device, power_fn=None if ops.label == "cuda"
                         else ops.power, depth=depth)
    pipe.warmup(ndf, nchk)
    before = collections.Counter(CP.launches)
    stats = []

    def run(n: int) -> float:
        t0 = time.perf_counter()
        stats.append(pipe.run((hosts[i % nhost] for i in range(n)),
                              MemorySink()))
        return time.perf_counter() - t0

    n1 = max(2, iters // 3)
    n2 = 3 * n1
    t1 = min(run(n1) for _ in range(2))
    t2 = min(run(n2) for _ in range(2))
    dt = (t2 - t1) / (n2 - n1)
    if dt <= 0:
        dt = t2 / n2
    counts = collections.Counter(CP.launches)
    counts.subtract(before)
    launches = sum(s.kernel_launches for s in stats)
    if ops.label == "cuda" and not launches:
        raise RuntimeError("--e2e: no CUDA kernel launched")
    stream_sec = ndf * C.TDF_SEC
    return {
        "metric": "end-to-end realtime multiple (host->H2D->kernel->fetch, "
                  f"pipelined, {ops.label})",
        "value": stream_sec / dt,
        "unit": "x realtime",
        "vs_baseline": stream_sec / dt,
        "block_sec": dt,
        "block_stream_sec": stream_sec,
        "depth": depth,
        "nblocks": sum(s.nblocks for s in stats),
        "kernel_launches": launches,
        "wrappers": {k: v for k, v in sorted(counts.items()) if v > 0},
        "device": card(device),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.bench",
        description="baseband -> power throughput on one card; prints one "
        "JSON line")
    add_platform(ap)
    ap.add_argument("--impl", default="auto", choices=["auto", "cuda",
                                                       "torch"],
                    help="auto: the CUDA kernels on --platform cuda, the "
                    "plain versions on cpu; torch: the plain PyTorch "
                    "versions on the chosen device")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--matrix", action="store_true",
                    help="measure the full detection-mode matrix (power/"
                    "stokes/scrunch/pfb-rows) and fold it into the one "
                    "JSON line; the default when no mode flag is given")
    ap.add_argument("--single", action="store_true",
                    help="headline direct-power measurement only")
    ap.add_argument("--quick", action="store_true",
                    help=f"reduced block ({QUICK_NDF} frames) for smoke "
                    "testing")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="benchmark the PFB channelizer path instead")
    ap.add_argument("--stokes", action="store_true",
                    help="benchmark the full-Stokes detection path instead")
    ap.add_argument("--scrunch", type=int, default=0, metavar="NOUT",
                    help="benchmark sub-block integration (NOUT spectra "
                    "per block) instead")
    ap.add_argument("--device-layout", action="store_true",
                    help="feed the PFB path series rows (capture "
                    "--device-layout blocks) instead of wire-order blocks")
    ap.add_argument("--h2d", action="store_true",
                    help="measure host->device transfer of a full block")
    ap.add_argument("--e2e", action="store_true",
                    help="measure PowerPipeline's source->H2D->kernel->fetch "
                    "loop including transfers")
    return ap


def result(argv=None) -> dict:
    """Parse ``argv``, run the mode it names, return its JSON line."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.platform == "cpu" and args.h2d:
        ap.error("--h2d times a host -> device copy; --platform cpu has no "
                 "device to copy to")
    if args.platform == "cpu" and args.impl == "cuda":
        ap.error("--impl cuda needs --platform cuda")
    if args.pfb and args.device_layout:
        try:
            PF.check_rows_nfft(args.pfb)
        except ValueError as e:
            ap.error(str(e))
    device = device_for(ap, args.platform)
    impl = args.impl
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "torch"
    ops = ops_for(impl, device)
    ndf = QUICK_NDF if args.quick else C.NDF_BLK

    if args.h2d:
        return bench_h2d(ndf, max(3, args.iters // 3), device)
    if args.e2e:
        return bench_e2e(ndf, args.iters, ops, device)
    mode_flag = (args.pfb or args.stokes or args.scrunch
                 or args.device_layout or args.single
                 or args.impl != "auto"
                 or args.quick)  # --quick stays a fast single-mode smoke
    if args.matrix or not mode_flag:
        return bench_matrix(ndf, args.iters, ops, device)
    return bench_single(args, ndf, ops, device)


def main(argv=None) -> int:
    print(json.dumps(result(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
