#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package: every kernel is
held against the port's own plain PyTorch version (int64, exact, for power
and Stokes; float64 for the PFB and the probes), which the CPU tests hold
against the JAX package's golden models.

Phases, each of which raises on failure (the script then exits non-zero):
  1. environment: device, ``nvidia-smi`` name and power limit, nvcc, torch;
  2. build the CUDA kernels from ``paf_baseband2power_tpu_torch/csrc``
     and print each kernel's registers from the build's ptxas report;
  3. power and Stokes kernels vs the plain int64 versions at 256 x 48
     (nout 1/8/256) and 200 x 48 (nout 1/2), wire and rows, mean on and
     off: bit-equal; the PFB kernel vs its plain version in float64 at the
     same two sizes (nfft 32-1024, ntap 1/4/8 at 1024, nout 1 and more,
     power and Stokes, mean on and off, wire and rows, with and without a
     carry): within 2e-5, peak-normalized, and two calls bit-equal; the
     shapes the kernel does not take (nfft 2048, ntap 12) through the
     executor's torch.fft route, counted as ``pfb_torch``;
  4. kernels vs their plain PyTorch versions at the production 8192 x 48
     block, full-range int16 drawn on the device, an all -32768 block and,
     for Stokes, a block whose y is x turned by 90 degrees (V = -I):
     bit-equal; the PFB kernel at nfft 128 and 1024, power and Stokes,
     nout 1 and 64 on wire, nout 1 and 8 on rows with the carry (the
     bench's rows modes), vs its plain version in float64: within 2e-5;
  5. the main paths through the port's CLI: recordings written with the
     port's ``paf_gen`` (1024 x 48, wire and ORDER SERIES) checked against
     the plain version (and ``--pfb 2048`` and ``--pfb 128 --ntap 12``,
     the torch.fft route, on the wire one), then recordings of full 8192 x
     48 blocks checked
     against the plain versions: the power path (wire, wire x 64 spectra,
     ORDER SERIES), the Stokes path (the same three with ``--stokes``,
     NPOL 4 headers) and the PFB path (``--pfb 128`` and ``--pfb 1024
     --stokes --nspectra 8`` on the wire recording, ``--pfb 128`` on the
     rows one; their blocks cross carry boundaries, and every record is
     held against the plain streaming version in float64 within 2e-5),
     with each path's launch counts set to 0 before each of its runs and
     read after;
  6. ms per block of each kernel and of its plain version at 8192 x 48
     (CUDA events, after a warm-up; the PFB's plain version in float32),
     with the least time the card could take (bytes over 3.35 TB/s or
     operations over 67 TFLOP/s, the larger);
  7. the spectrometer probes (K11-K13): micro, planes and Karatsuba
     kernels vs their plain versions at small sizes and at 8192 x 48
     (int16 in [-256, 256)): micro exact, planes (every stage_a) and
     Karatsuba (R 1024 and 2048) within 2e-5 of the float64 plain version;
     their ms per block beside the plain versions' and, for micro,
     ``torch.sum``'s; for planes and Karatsuba, whose 128-point DFTs run
     on the tensor cores (``csrc/tc_dft.cuh``), the floor of those products
     at 3xBF16, two calls bit-equal, each kernel's ptxas line and the
     ``HMMA``/``HGMMA`` instructions in its SASS (``cuobjdump -sass``;
     none is a failure); then the probes path: both probes' ``main`` at
     full size with a small ``--iters``, their launch counts set to 0 just
     before and read after;
  8. the process topology, each entry point run as a user runs it, in
     processes of its own, ``--platform cuda``:
     a. while each of phase 5b's full-size recordings is on disk, the
        launcher in ring mode (``paf_diskdb`` -> ring -> compute -> ring ->
        ``paf_dbdisk``, uuid ring keys, input ring ``NBLK 2``): power on the
        wire file, ``--pfb 1024 --stokes --nspectra 8`` on it, power on the
        ORDER SERIES file; every record byte-equal to the CLI's file-mode
        output of phase 5b, the header equal, the rings gone, the compute
        stage's log showing kernel launches;
     b. on phase 5a's 1024 x 48 wire recording: ``--raw-spill`` (the spilled
        payload byte-equal to the recording's) and ``--mode file`` (records
        equal to the CLI's);
     c. after phase 7, ``paf_soak`` (UDP capture over loopback -> ring ->
        CUDA compute) at 1024 x 48 on 6 ports, ``--device-layout``, power
        and ``--pfb 128 --nspectra 64``, 10 s each at ``SOAK_RATE``, then
        at 1024 x 2 on one port, rate 1.0, 5 s: each report passes, with
        kernel launches, within three runs.
     ``/dev/shm``'s free bytes and ``MemAvailable`` are printed before each.
  9. the multi-device runtime, ``paf_multihost --platform cuda`` run as
     processes on phase 5b's full-size recordings while each is on disk,
     every rank reading its own slice of each block:
     a. world size 1, ``--dist-backend nccl``: power, ``--stokes`` and
        ``--pfb 1024 --stokes --nspectra 8`` (3 blocks, the carry across
        them) on the wire file, ``--device-layout --pfb 128`` on the rows
        file;
     b. world size 2 on the one card (``gloo``, both ranks on cuda:0):
        time-sharded power, time-sharded ``--pfb 1024 --stokes --nspectra
        8`` (the halo and the carry cross ranks), the same with
        ``--scatter-output``, ``--nbeam 2`` beam-sharded power (the wire
        file for both beams), and ``--device-layout`` power (series split
        over the ranks);
     power and Stokes records bit-equal to phase 5b's single-device CLI
     records of the same blocks, the PFB's within 2e-5 peak-normalized;
     every run's ranks launch kernels, their counts summed per wrapper;
     c. with phase 8c, ``paf_soak --sharded-rows --device-layout --pfb 128
        --nspectra 64`` at ``SOAK_RATE``.
 10. the port's bench (``python -m paf_baseband2power_tpu_torch.bench``)
     as processes at 8192 x 48: the default 10-mode matrix, ``--single``,
     ``--stokes --scrunch 64``, ``--pfb 128``, ``--pfb 1024 --device-layout
     --stokes --scrunch 8``, ``--pfb 2048`` (the torch.fft route, named in
     its label), ``--h2d`` and ``--e2e --iters 6``: each line printed, its
     keys present, its value positive, its card phase 1's; every mode
     launched one wrapper, a CUDA one unless its label names the torch.fft
     route (``--e2e``: ``baseband2power_cuda``); where phase 6 timed the same
     wrapper at the same shape, the mode's ``block_ms`` within 2x of that
     time, else printed beside the nearest.
The last two lines are the kernels' JSON record and the result line.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# outside a checkout this import fails, and the script with it. The fp32
# rate is also the one used for the detection kernels' integer work.
from paf_baseband2power_tpu_torch.h100 import (  # noqa: E402
    BF16_FLOPS, FP32_FLOPS, HBM_BPS)

FULL_NDF, NCHK = 8192, 48
CSRC = "paf_baseband2power_tpu_torch/csrc/"
PALLAS = "paf_baseband2power_tpu/ops/pallas_power.py"
PALLAS_PFB = "paf_baseband2power_tpu/ops/pallas_pfb.py"
REFERENCE = PALLAS.split("/", 1)[0]      # the JAX package, never imported
PROBE_WIDE = "benchmarks/probe_wide_reshape.py"
PROBE_KAR = "benchmarks/probe_karatsuba.py"
BOUND_PFB = 2e-5     # peak-normalized, benchmarks/parity_tpu.py:BOUND_PFB
# wrapper -> (its kernel's source, the pl.pallas_call it replaces). K2's
# call stands for K3's at :290, the same entry point's other tile class;
# K8's (:609, the tile class of nout 1 at 8192 frames) for K7's packed
# tile class at :576.
KERNELS = {
    "baseband2power_cuda": ("power.cu", f"{PALLAS}:103"),
    "baseband2power_scrunch_cuda": ("power.cu", f"{PALLAS}:250"),
    "baseband2power_scrunch_rows_cuda": ("power.cu", f"{PALLAS}:776"),
    "baseband2stokes_cuda": ("stokes.cu", f"{PALLAS}:703"),
    "baseband2stokes_scrunch_cuda": ("stokes.cu", f"{PALLAS}:397"),
    "baseband2stokes_scrunch_rows_cuda": ("stokes.cu", f"{PALLAS}:609"),
    "pfb_power_cuda": ("pfb.cu", f"{PALLAS_PFB}:213"),
    "pfb_spectra_cuda": ("pfb.cu", f"{PALLAS_PFB}:679"),
    "micro_cuda": ("probe_micro.cu", f"{PROBE_WIDE}:77"),
    "planes_cuda": ("probe_planes.cu", f"{PROBE_WIDE}:226"),
    "karatsuba_planar_cuda": ("probe_karatsuba.cu", f"{PROBE_KAR}:116"),
}
PATHS = {"power": [k for k in KERNELS if k.startswith("baseband2power")],
         "stokes": [k for k in KERNELS if k.startswith("baseband2stokes")],
         "pfb": [k for k in KERNELS if k.startswith("pfb")],
         "probes": ["micro_cuda", "planes_cuda", "karatsuba_planar_cuda"]}
CLI_PATHS = ("power", "stokes", "pfb")     # driven through the CLI
# PFB cases of phase 3: nfft, ntap, nout, stokes, mean (each on wire, on
# rows for nfft 128-1024, with and without a carry, where the frame count
# allows the shape)
PFB_CASES = [(32, 4, 1, False, False), (32, 8, 8, True, True),
             (64, 2, 2, False, True), (64, 4, 1, True, False),
             (128, 1, 1, False, True), (128, 4, 4, True, False),
             (128, 8, 2, False, True), (128, 4, 64, True, True),
             (256, 4, 1, True, True), (256, 8, 4, False, False),
             (512, 4, 1, False, True), (512, 8, 2, True, False),
             (1024, 4, 1, False, False), (1024, 4, 1, True, True),
             (1024, 8, 2, True, True), (1024, 8, 1, False, True),
             (1024, 1, 1, True, False), (1024, 1, 1, False, True)]
# shapes the CUDA kernel does not take, which go through torch.fft on the
# card: nfft, ntap, nout, stokes
PFB_TORCH_CASES = [(2048, 4, 1, False), (128, 12, 2, True)]
# phase 9's runs of paf_multihost on phase 5b's recordings, per layout:
# (ranks, backend, flags, phase 5b's CLI flags of the same records, beams)
PFB_MULTI = ("--pfb", "1024", "--stokes", "--nspectra", "8")
MULTI_RUNS = {
    "wire": [(1, "nccl", (), (), 1),
             (1, "nccl", ("--stokes",), ("--stokes",), 1),
             (1, "nccl", PFB_MULTI, PFB_MULTI, 1),
             (2, "gloo", (), (), 1),
             (2, "gloo", PFB_MULTI, PFB_MULTI, 1),
             (2, "gloo", PFB_MULTI + ("--scatter-output",), PFB_MULTI, 1),
             (2, "gloo", (), (), 2)],
    "rows": [(1, "nccl", ("--device-layout", "--pfb", "128"),
              ("--pfb", "128"), 1),
             (2, "gloo", ("--device-layout",), (), 1)],
}
# the wrappers the multi-device path must launch (K1, K4, K5, K10)
MULTI_KERNELS = ("baseband2power_cuda", "baseband2power_scrunch_rows_cuda",
                 "baseband2stokes_cuda", "pfb_spectra_cuda")
# phase 8c's stream rate at full channel width, as a multiple of real time:
# half the highest of 0.1, 0.25, 0.5 and 1.0 at which paf_soak passed at
# 1024 x 48 on 6 ports over loopback on the H100's 8-core host (0.1, both
# modes; PERF.md, PR 7)
SOAK_RATE = 0.05
# phase 10: the bench's runs, each with, for a single mode, phase 6's time
# that its block_ms is set beside (None: no such time) and whether that is
# the same wrapper at the same shape (held within 2x) or only the nearest
# (printed beside it); the matrix's rows have theirs in BENCH_MATRIX
BENCH_RUNS = [
    ((), None),
    (("--single",), ("baseband2power_cuda", True)),
    (("--stokes", "--scrunch", "64"), ("baseband2stokes_scrunch_cuda", True)),
    (("--pfb", "128"), ("pfb_power_cuda (nfft 128 power)", True)),
    (("--pfb", "1024", "--device-layout", "--stokes", "--scrunch", "8"),
     ("pfb_spectra_cuda (nfft 1024 Stokes)", False)),
    (("--pfb", "2048"), (None, False)),     # the torch.fft route
    (("--h2d",), None),
    (("--e2e", "--iters", "6"), None),
]
# the matrix's 10 rows, in its order, each with its phase 6 reference
BENCH_MATRIX = {
    "power": ("baseband2power_cuda", True),
    "power rows": ("baseband2power_scrunch_rows_cuda", True),
    "stokes": ("baseband2stokes_cuda", True),
    "scrunch[64]": ("baseband2power_scrunch_cuda", True),
    "stokes x scrunch[64]": ("baseband2stokes_scrunch_cuda", True),
    "stokes rows": ("baseband2stokes_scrunch_rows_cuda", True),
    "stokes x scrunch[64] rows": ("baseband2stokes_scrunch_rows_cuda", False),
    "pfb 128 rows streaming": ("pfb_power_cuda (nfft 128 power)", False),
    "pfb 128 x stokes rows streaming": ("pfb_spectra_cuda (nfft 128 Stokes)",
                                        False),
    "pfb 1024 rows streaming": ("pfb_power_cuda (nfft 1024 power)", False),
}
# the keys of each kind of bench line (and of a matrix row)
BENCH_KEYS = {
    "matrix": {"metric", "value", "unit", "vs_baseline", "hbm_fraction",
               "matrix", "device"},
    "row": {"mode", "block_ms", "x_realtime", "samples_per_sec",
            "hbm_fraction", "launches", "wrappers"},
    "single": {"metric", "value", "unit", "vs_baseline", "block_ms",
               "hbm_fraction", "launches", "wrappers", "device"},
    "h2d": {"metric", "value", "unit", "vs_baseline", "block_bytes",
            "block_sec", "pinned_bytes_per_sec", "pinned_block_sec",
            "pinned_vs_baseline", "device"},
    "e2e": {"metric", "value", "unit", "vs_baseline", "block_sec",
            "block_stream_sec", "depth", "nblocks", "kernel_launches",
            "wrappers", "device"},
}


def log(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"FAILED: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time in ms the card could take: bytes moved over the HBM
    rate or fp32 operations over the fp32 rate, the larger, and which it
    is."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pfb_ops(nsamp: int, nfft: int, ntap: int, stokes: bool) -> float:
    """fp32 operations of the PFB on ``nsamp`` complex samples: FIR
    (4 ntap), radix-2 FFT (5 log2 nfft) and detection (4 power, 6 Stokes)
    per sample."""
    return nsamp * (4 * ntap + 5 * math.log2(nfft) + (6 if stokes else 4))


def planes_ops(nseries: int, nrow: int, nfft: int, ntap: int,
               stage_a: str) -> float:
    """Least fp32 operations of the planes probe's function on its valid
    windows, per sample: FIR (4 ntap); stage A as an n1-point FFT (5 log2
    n1 for ``full`` and ``fft8``, plus 4 to fold k1 with -k1 for
    ``noswap``'s real twiddles, whichever of that and the direct 4 n1 is
    less; 0 for ``none``); the twiddle (6); the 128-point FFT (35);
    |y|^2 (3)."""
    n1 = nfft // 128
    fft = 5 * math.log2(n1)
    stage = {"full": fft, "fft8": fft, "noswap": min(fft + 4, 4 * n1),
             "none": 0}
    return (nseries * (nrow - ntap + 1) * nfft
            * (4 * ntap + stage[stage_a] + 6 + 35 + 3))


def karatsuba_ops(nseries: int, ndf: int,
                  ntap: int) -> tuple[float, float]:
    """Operations of the Karatsuba probe on its valid windows: ``(least,
    products)``. Least: the function's fp32 work, FIR (4 ntap), a 128-point
    FFT (35) and |y|^2 (3) per sample. Products: the three 128 x 128 real
    products ``csrc/probe_karatsuba.cu`` runs on the tensor cores."""
    nwin = nseries * (ndf - ntap + 1)
    return nwin * 128 * (4 * ntap + 35 + 3), nwin * 3 * 2 * 128 * 128


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel, ``<source> <kernel>: <registers, shared
    memory, spills>``, from the build's ptxas report."""
    lines, src = [], ""
    for line in report.splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif "Compiling entry function" in line:
            lines.append(f"{src} {line.split(chr(39))[1]}:")
        elif lines and ("spill" in line or "Used" in line):
            lines[-1] += " " + line.split(":", 1)[-1].strip()
    return lines


def run_pfb(blk, nfft, ntap, nout, stokes, mean, carry, layout,
            plain=True):
    """The PFB kernel (``pfb_power_cuda`` for nout 1 power, else
    ``pfb_spectra_cuda``) and, with ``plain``, its plain version in float64
    on one block; returns ``(wrapper name, kernel result, plain result or
    None)``."""
    from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF
    from paf_baseband2power_tpu_torch.ops import pfb as PF

    kw = dict(mean=mean, history=carry, layout=layout)
    if nout == 1 and not stokes:
        return ("pfb_power_cuda", CF.pfb_power_cuda(blk, nfft, ntap, **kw),
                PF.pfb_power(blk, nfft, ntap, dtype=torch.float64, **kw)
                if plain else None)
    kw.update(nout=nout, stokes=stokes)
    return ("pfb_spectra_cuda", CF.pfb_spectra_cuda(blk, nfft, ntap, **kw),
            PF.pfb_spectra(blk, nfft, ntap, dtype=torch.float64, **kw)
            if plain else None)


def run_cli(cli, argv: list[str]) -> dict:
    """Run the port's CLI in this process; returns its --stats-json."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--stats-json"])
    check(rc == 0, f"CLI {argv} exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def pfb_torch_cli(cli, path: str, ndf: int, tmp: str, dev: torch.device,
                  nfft: int, ntap: int) -> str:
    """``--pfb nfft --ntap ntap``, a shape the kernel does not take, through
    the CLI on the ``paf_gen`` wire recording at ``path`` (3 blocks of
    ``ndf`` x 48, seeds 5-7): the torch.fft route, each record within 2e-5
    of the plain streaming version in float64; returns a summary."""
    from paf_baseband2power_tpu_torch.ops import cuda_power as CP
    from paf_baseband2power_tpu_torch.ops import frame as F
    from paf_baseband2power_tpu_torch.ops import pfb as PF
    from paf_baseband2power_tpu_torch.probes._common import peak_err

    out = os.path.join(tmp, "pfb-torch.dada")
    what = f"--pfb {nfft} --ntap {ntap}"
    CP.launches.clear()
    stats = run_cli(cli, ["-a", path, "-b", out, "--ndf", str(ndf),
                          "--nchk", str(NCHK), "--pfb", str(nfft),
                          "--ntap", str(ntap)])
    launched = dict(CP.launches)
    hdr, recs = read_records(out, (NCHK * 7 * nfft,))
    check(hdr["PFB_NFFT"] == str(nfft) and hdr["PFB_NTAP"] == str(ntap)
          and len(recs) == 3, f"{what}: 3 records with its header "
          f"({len(recs)})")
    check(set(launched) == {"pfb_torch"} and launched["pfb_torch"] >= 3,
          f"{what} ran the torch.fft route only: {launched}")
    step = PF.make_streaming_pfb(nfft, ntap, dtype=torch.float64)
    carry, worst = None, 0.0
    for i, rec in enumerate(recs):
        blk = torch.from_numpy(F.synthetic_block(
            rng=5 + i, ndf=ndf, nchk=NCHK).reshape(ndf, -1)).to(dev)
        want, carry = step(blk, carry)
        e = peak_err(torch.from_numpy(np.array(rec)), want.cpu())[1]
        check(e < BOUND_PFB, f"{what} record {i}: {e:.3e} "
              "peak-normalized against the plain streaming version")
        worst = max(worst, e)
    os.remove(out)
    return (f"{what}: 3 records within {worst:.3e} (peak-normalized) of the "
            f"plain streaming version in float64, {stats['realtime_x']:.3f}x "
            f"real time, launches {launched}")


def read_records(path: str, shape: tuple) -> tuple[dict, list[np.ndarray]]:
    from paf_baseband2power_tpu_torch.io.dada import DadaFileReader

    with DadaFileReader(path) as r:
        nbytes = int(np.prod(shape)) * 4
        return r.header, [np.frombuffer(b, "<f4").reshape(shape)
                          for b in r.blocks(nbytes)]


def write_full_recording(path: str, layout: str, nblocks: int,
                         gen: torch.Generator, dev: torch.device) -> list:
    """Write ``nblocks`` full-range 8192 x 48 blocks drawn on the card to a
    .dada recording (``ORDER SERIES`` for rows); returns each block's plain
    records: ``[power, Stokes, PFB 128]`` for rows, ``[power, 64-window
    power, Stokes, 64-window Stokes, PFB 128, PFB 1024 Stokes x 8]`` for
    wire. The PFB records come from the plain streaming version in
    float64, its carry threaded from block to block."""
    from paf_baseband2power_tpu_torch.io.dada import (
        DadaFileWriter,
        baseband_header,
    )
    from paf_baseband2power_tpu_torch.ops import pfb as PF
    from paf_baseband2power_tpu_torch.ops import power as P

    extra = {"ORDER": "SERIES"} if layout == "rows" else None
    f64 = dict(layout=layout, dtype=torch.float64)
    steps = [PF.make_streaming_pfb(128, 4, **f64)]
    if layout == "wire":
        steps.append(PF.make_streaming_spectra(1024, 4, nout=8, stokes=True,
                                               **f64))
    carries = [None] * len(steps)
    refs = []
    with DadaFileWriter(path, baseband_header(nchan=NCHK * 7,
                                              extra=extra)) as w:
        for i in range(nblocks):
            gen.manual_seed(1000 + i)
            x = torch.randint(-32768, 32768,
                              (FULL_NDF, NCHK * P.LANES_PER_CHUNK),
                              dtype=torch.int16, device=dev, generator=gen)
            if layout == "rows":
                rows = x.view(NCHK * 14, FULL_NDF, P.ROW_LANES)
                refs.append([P.baseband2power_scrunch_rows(rows, 1)[0],
                             P.baseband2stokes_scrunch_rows(rows, 1)[0]])
            else:
                refs.append([P.baseband2power_2d(x),
                             P.baseband2power_scrunch_2d(x, 64),
                             P.baseband2stokes_2d(x),
                             P.baseband2stokes_scrunch_2d(x, 64)])
            for j, step in enumerate(steps):
                out, carries[j] = step(rows if layout == "rows" else x,
                                       carries[j])
                refs[-1].append(out)
            refs[-1] = [r.cpu().numpy() for r in refs[-1]]
            w.write(x.cpu().numpy())
    return refs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
    from paf_baseband2power_tpu_torch.cli import paf_gen
    from paf_baseband2power_tpu_torch.ops import _build
    from paf_baseband2power_tpu_torch.ops import frame as F
    from paf_baseband2power_tpu_torch.ops import cuda_power as CP
    from paf_baseband2power_tpu_torch.ops import power as P
    from paf_baseband2power_tpu_torch.probes._common import peak_err

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full float32 products in the plain versions: TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = _build.find_nvcc()
    check(nvcc is not None, "nvcc found")
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    log(f"[1] device: {torch.cuda.get_device_name(0)}")
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"python {sys.version.split()[0]}")
    log(f"[1] nvcc: {nvcc_ver.splitlines()[-1]}")
    log(f"[1] host: {os.uname().machine}, {os.cpu_count()} cores, "
        f"{host_memory()}")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"[2] built {os.path.relpath(lib_path, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in ptxas_lines(_build.ptxas_report(lib_path)) or [
            "no report: the library was built before this run"]:
        log(f"[2] ptxas {line}")
        check(not line.startswith("pfb.cu") or " 0 bytes spill stores" in line,
              f"no spills in the PFB kernels: {line}")

    # --- 3. kernels vs the plain int64 versions at 256 x 48 (and 200 x 48)
    # 256 frames: nout 1/8/256 as in the main path's shapes; 200 frames:
    # windows of 200 and 100 frames end in a partial 64-frame slab and have
    # mean divisors that are not powers of two.
    CP.launches.clear()
    for ndf, nouts in ((256, (1, 8, 256)), (200, (1, 2))):
        block = F.synthetic_block(rng=11, ndf=ndf, nchk=NCHK)
        wire = torch.from_numpy(block.reshape(ndf, -1)).to(dev)
        rows = torch.from_numpy(F.block_to_rows(block)).to(dev)
        raw = torch.from_numpy(np.frombuffer(F.block_to_bytes(block),
                                             np.uint8).copy()).to(dev)
        host = torch.from_numpy(block.reshape(ndf, -1))    # plain, on the CPU
        for mean in (False, True):
            want = P.baseband2power_2d(host, mean=mean).numpy()
            for name, got in (
                    ("wire", CP.baseband2power_cuda(wire, mean=mean)),
                    ("bytes", CP.baseband2power_cuda_bytes(raw, ndf, NCHK,
                                                           mean=mean))):
                check(np.array_equal(got.cpu().numpy(), want),
                      f"{ndf} frames {name} nout=1 mean={mean} bit-equal "
                      "to the plain version")
            for nout in nouts:
                want = P.baseband2power_scrunch_2d(host, nout,
                                                   mean=mean).numpy()
                for name, got in (
                        ("wire", CP.baseband2power_scrunch_cuda(
                            wire, nout, mean=mean)),
                        ("rows", CP.baseband2power_scrunch_rows_cuda(
                            rows, nout, mean=mean))):
                    check(np.array_equal(got.cpu().numpy(), want),
                          f"{ndf} frames {name} nout={nout} mean={mean} "
                          "bit-equal to the plain version")
            want = P.baseband2stokes_2d(host, mean=mean).numpy()
            check(np.array_equal(
                CP.baseband2stokes_cuda(wire, mean=mean).cpu().numpy(),
                want), f"{ndf} frames Stokes wire mean={mean} bit-equal "
                "to the plain version")
            for nout in nouts:
                want = P.baseband2stokes_scrunch_2d(host, nout,
                                                    mean=mean).numpy()
                for name, got in (
                        ("wire", CP.baseband2stokes_scrunch_cuda(
                            wire, nout, mean=mean)),
                        ("rows", CP.baseband2stokes_scrunch_rows_cuda(
                            rows, nout, mean=mean))):
                    check(np.array_equal(got.cpu().numpy(), want),
                          f"{ndf} frames Stokes {name} nout={nout} "
                          f"mean={mean} bit-equal to the plain version")
    counts = {path: sum(CP.launches[k] for k in PATHS[path])
              for path in ("power", "stokes")}
    check(counts == {"power": 28, "stokes": 24},
          f"launch counters rose by 28 (power) and 24 (Stokes): {counts}")
    log("[3] 256 x 48 (nout 1/8/256) and 200 x 48 (nout 1/2): power (wire, "
        "bytes, rows) and Stokes (wire, rows), mean off/on: bit-equal to the "
        "plain int64 versions")

    # PFB: full-range int16 drawn on the card; the carry is the tail of
    # another such block
    from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF
    from paf_baseband2power_tpu_torch.ops import pfb as PF

    gen = torch.Generator(device=dev)
    pfb_err = {name: [0.0, 0.0] for name in PATHS["pfb"]}   # abs, peak-norm
    CP.launches.clear()
    calls = collections.Counter()
    for ndf in (256, 200):
        gen.manual_seed(ndf)
        x, prev = (torch.randint(-32768, 32768, (ndf, NCHK * 3584),
                                 dtype=torch.int16, device=dev, generator=gen)
                   for _ in range(2))
        nsamp = ndf * 128
        for nfft, ntap, nout, stokes, mean in PFB_CASES:
            if nsamp % nfft or nsamp // nfft % nout:
                continue
            for layout in (("wire", "rows") if nfft in PF.ROWS_NFFTS
                           else ("wire",)):
                view = ((lambda t: t) if layout == "wire"
                        else (lambda t: t.view(NCHK * 14, ndf, 256)))
                for carry in (None,
                              PF.pfb_history(view(prev), nfft, ntap, layout)):
                    name, got, want = run_pfb(view(x), nfft, ntap, nout,
                                              stokes, mean, carry, layout)
                    _, again, _ = run_pfb(view(x), nfft, ntap, nout, stokes,
                                          mean, carry, layout, plain=False)
                    calls[name] += 2
                    check(torch.equal(got, again),
                          f"PFB {ndf} frames {layout} nfft={nfft} "
                          f"ntap={ntap}: two calls bit-equal")
                    e = peak_err(got, want)
                    pfb_err[name] = [max(a, b) for a, b in
                                     zip(pfb_err[name], e)]
                    check(got.shape == want.shape and e[1] < BOUND_PFB,
                          f"PFB {ndf} frames {layout} nfft={nfft} ntap={ntap} "
                          f"nout={nout} stokes={stokes} mean={mean} carry="
                          f"{carry is not None}: {e[1]:.3e} peak-normalized "
                          "against the float64 plain version")
    check(dict(CP.launches) == dict(calls),
          f"PFB launch counters {dict(CP.launches)} match calls "
          f"{dict(calls)}")
    log(f"[3] PFB 256 x 48 and 200 x 48, {sum(calls.values()) // 2} cases, "
        f"each twice and bit-equal: within {BOUND_PFB} of the float64 plain "
        f"version (max abs, peak-normalized: {pfb_err})")
    # the shapes the kernel does not take: the executor's torch.fft route,
    # two blocks with the carry between them
    from paf_baseband2power_tpu_torch.runtime.pipeline import PowerPipeline

    gen.manual_seed(256)
    blocks = [torch.randint(-32768, 32768, (256, NCHK * 3584),
                            dtype=torch.int16, device=dev, generator=gen)
              for _ in range(2)]
    for nfft, ntap, nout, stokes in PFB_TORCH_CASES:
        pipe = PowerPipeline(dev, nout=nout, stokes=stokes, pfb_nfft=nfft,
                             pfb_ntap=ntap)
        check("torch.fft" in pipe._mode(), f"nfft={nfft} ntap={ntap}: "
              f"torch.fft route, not {pipe._mode()}")
        plain = PF.make_streaming_spectra(nfft, ntap, nout=nout, stokes=stokes,
                                          dtype=torch.float64)
        carry = None
        CP.launches.clear()
        for blk in blocks:
            want, carry = plain(blk, carry)
            got = pipe.power(blk)
            e = peak_err(got, want if stokes or nout > 1 else want[0])
            check(e[1] < BOUND_PFB, f"torch.fft route nfft={nfft} ntap={ntap}"
                  f": {e[1]:.3e} peak-normalized against float64")
        check(dict(CP.launches) == {"pfb_torch": 2},
              f"torch.fft route counted: {dict(CP.launches)}")
        log(f"[3] PFB nfft={nfft} ntap={ntap} nout={nout} stokes={stokes}, "
            f"2 blocks of 256 x 48 with their carry: {pipe._mode()}, "
            f"{e[1]:.3e} peak-normalized against float64, "
            f"launches {dict(CP.launches)}")
    del blocks

    # --- 4. kernels vs plain versions at 8192 x 48 ------------------------
    big = torch.empty((FULL_NDF, NCHK * P.LANES_PER_CHUNK), dtype=torch.int16,
                      device=dev)
    big_rows = big.view(NCHK * 14, FULL_NDF, P.ROW_LANES)

    def fill(kind: str, layout: str) -> None:
        """Fill ``big`` in place: full-range random, all -32768, or random
        with y = i x in ``layout``'s pairing (xi kept off -32768 so that
        -xi is an int16): Q = U = 0 and V = -I exactly."""
        if kind == "-32768":
            big.fill_(-32768)
            return
        gen.manual_seed(20261016)
        torch.randint(-32768, 32768, big.shape, dtype=torch.int16,
                      device=dev, generator=gen, out=big)
        if kind == "turned":
            if layout == "wire":     # lanes (xr, xi, yr, yi) per group
                v = big.view(FULL_NDF, -1, 2, 2)
                x, y = v[..., 0, :], v[..., 1, :]
            else:                    # series 2k, 2k + 1; (re, im) lanes
                v = big.view(NCHK * 7, 2, FULL_NDF, P.ROW_LANES // 2, 2)
                x, y = v[:, 0], v[:, 1]
            x[..., 1].clamp_(min=-32767)
            y[..., 0] = -x[..., 1]
            y[..., 1] = x[..., 0]

    rows_shape = big_rows.shape
    cases = {   # name: (layout, fills, kernel and plain on the block)
        "baseband2power_cuda": ("wire", ("random", "-32768"), lambda x: (
            CP.baseband2power_cuda(x), P.baseband2power_2d(x))),
        "baseband2power_scrunch_cuda": ("wire", ("random", "-32768"),
                                        lambda x: (
            CP.baseband2power_scrunch_cuda(x, 64),
            P.baseband2power_scrunch_2d(x, 64))),
        "baseband2power_scrunch_rows_cuda": ("rows", ("random", "-32768"),
                                             lambda x: (
            CP.baseband2power_scrunch_rows_cuda(x.view(rows_shape), 1),
            P.baseband2power_scrunch_rows(x.view(rows_shape), 1))),
        "baseband2stokes_cuda": ("wire", ("random", "-32768", "turned"),
                                 lambda x: (
            CP.baseband2stokes_cuda(x), P.baseband2stokes_2d(x))),
        "baseband2stokes_scrunch_cuda": ("wire",
                                         ("random", "-32768", "turned"),
                                         lambda x: (
            CP.baseband2stokes_scrunch_cuda(x, 64),
            P.baseband2stokes_scrunch_2d(x, 64))),
        "baseband2stokes_scrunch_rows_cuda": ("rows",
                                              ("random", "-32768", "turned"),
                                              lambda x: (
            CP.baseband2stokes_scrunch_rows_cuda(x.view(rows_shape), 1),
            P.baseband2stokes_scrunch_rows(x.view(rows_shape), 1))),
    }
    err = {name: 0.0 for name in cases}
    for kind, layout in (("random", None), ("-32768", None),
                         ("turned", "wire"), ("turned", "rows")):
        fill(kind, layout)
        for name, (lay, fills, fn) in cases.items():
            if kind not in fills or layout not in (None, lay):
                continue
            got, want = fn(big)
            err[name] = max(err[name], (got - want).abs().max().item())
            check(torch.equal(got, want),
                  f"{name} ({kind}) bit-equal to the plain version")
            if "stokes" not in name or kind == "random":
                continue
            i, q, u, v = got.reshape(-1, 4, NCHK * 7).unbind(dim=1)
            if kind == "-32768":
                # FULL_NDF x 128 samples of I = 2^32, over the windows
                check(bool((i == FULL_NDF * 128 * 2.0 ** 32
                            / i.shape[0]).all()
                           and (q == 0).all() and torch.equal(u, i)
                           and (v == 0).all()),
                      f"{name} all -32768: I = U = 2^32 per sample, "
                      "Q = V = 0")
            else:
                check(bool((q == 0).all() and (u == 0).all()
                           and torch.equal(v, -i)),
                      f"{name} y = i x: Q = U = 0, V = -I")
        if kind == "turned":
            continue
        for nout in (1, 64):
            for kern, plain in ((CP.baseband2power_scrunch_rows_cuda,
                                 P.baseband2power_scrunch_rows),
                                (CP.baseband2stokes_scrunch_rows_cuda,
                                 P.baseband2stokes_scrunch_rows)):
                got = kern(big_rows, nout, mean=True)
                check(torch.equal(got, plain(big_rows, nout, mean=True)),
                      f"{kern.__name__} nout={nout} mean ({kind}) "
                      "bit-equal to plain")
        if kind == "-32768":
            pw = CP.baseband2power_scrunch_rows_cuda(big_rows, 64, mean=True)
            check(bool((pw == 2.0 ** 31).all()),
                  "all -32768 block: mean power 2 x 2^30 per channel sample")
            check(bool((got[:, 0] == 2.0 ** 32).all()),
                  "all -32768 block: mean Stokes I 2^32 per sample")
    log(f"[4] 8192 x 48: random and all -32768 blocks (power and Stokes), "
        f"y = i x blocks (Stokes), wire/rows, nout 1 and 64: bit-equal to the "
        f"plain versions (max abs err {err})")
    fill("random", None)
    prev = big.flip(0)      # the carry: the tail of another full-range block
    for nfft in (128, 1024):
        for stokes in (False, True):
            for nout in (1, 64):
                carry = (PF.pfb_history(prev, nfft, 4) if nout == 64
                         else None)
                name, got, want = run_pfb(big, nfft, 4, nout, stokes, False,
                                          carry, "wire")
                e = peak_err(got, want)
                pfb_err[name] = [max(a, b) for a, b in zip(pfb_err[name], e)]
                check(e[1] < BOUND_PFB,
                      f"PFB 8192 x 48 nfft={nfft} stokes={stokes} "
                      f"nout={nout}: {e[1]:.3e} peak-normalized against the "
                      "float64 plain version")
                log(f"[4] PFB 8192 x 48 nfft={nfft} stokes={stokes} "
                    f"nout={nout} carry={carry is not None}: max abs err "
                    f"{e[0]:.6g}, peak-normalized {e[1]:.3e}")
                del got, want
    # series rows, as the bench's rows modes and --device-layout feed them:
    # pfb_spectra_cuda at every nout (the streaming step's wrapper), with
    # the carry of another full-range block
    prev_rows = prev.view(rows_shape)
    for nfft in (128, 1024):
        carry = PF.pfb_history(prev_rows, nfft, 4, "rows")
        for stokes in (False, True):
            for nout in (1, 8):
                kw = dict(nout=nout, stokes=stokes, history=carry,
                          layout="rows")
                got = CF.pfb_spectra_cuda(big_rows, nfft, 4, **kw)
                want = PF.pfb_spectra(big_rows, nfft, 4, dtype=torch.float64,
                                      **kw)
                e = peak_err(got, want)
                pfb_err["pfb_spectra_cuda"] = [
                    max(a, b) for a, b in zip(pfb_err["pfb_spectra_cuda"], e)]
                check(e[1] < BOUND_PFB,
                      f"PFB rows 8192 x 48 nfft={nfft} stokes={stokes} "
                      f"nout={nout}: {e[1]:.3e} peak-normalized against the "
                      "float64 plain version")
                log(f"[4] PFB rows 8192 x 48 nfft={nfft} stokes={stokes} "
                    f"nout={nout} carry=True: max abs err {e[0]:.6g}, "
                    f"peak-normalized {e[1]:.3e}")
                del got, want
    del big, big_rows, prev, prev_rows, carry

    # --- 5. main path through the CLI ----------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke-") as tmp:
        # 5a. paf_gen recordings at 1024 x 48 against the golden model
        ndf = 1024
        for layout in ("wire", "rows"):
            bb = os.path.join(tmp, f"gen-{layout}.dada")
            pw = os.path.join(tmp, f"gen-{layout}-power.dada")
            gen_args = ["-o", bb, "-n", "3", "--ndf", str(ndf), "--nchk",
                        str(NCHK), "--seed", "5"]
            if layout == "rows":
                gen_args.append("--device-layout")
            with contextlib.redirect_stdout(io.StringIO()):
                check(paf_gen.main(gen_args) == 0, "paf_gen")
            stats = run_cli(cli, ["-a", bb, "-b", pw, "--ndf", str(ndf),
                                  "--nchk", str(NCHK)])
            _, recs = read_records(pw, (NCHK * 7,))
            check(len(recs) == 3 and stats["kernel_launches"] == 3,
                  f"{layout}: 3 records from 3 kernel launches")
            for i, rec in enumerate(recs):
                want = P.baseband2power_2d(torch.from_numpy(
                    F.synthetic_block(rng=5 + i, ndf=ndf,
                                      nchk=NCHK).reshape(ndf, -1))).numpy()
                check(np.array_equal(rec, want),
                      f"{layout} record {i} bit-equal to the plain version")
            if layout == "wire":   # shapes the kernel does not take
                pfb_torch = [pfb_torch_cli(cli, bb, ndf, tmp, dev, nfft, ntap)
                             for nfft, ntap in ((2048, 4), (128, 12))]
                # 8b. the launcher's raw spill and file mode on this file
                topology = spill_phase(bb, ndf, pw, tmp, smi)
            os.remove(bb)
        log("[5a] CLI on paf_gen recordings 3 x 1024 x 48, wire and ORDER "
            "SERIES: every record bit-equal to the plain int64 version")
        for line in pfb_torch:
            log(f"[5a] CLI on the wire recording, torch.fft route, {line}")

        # 5b. full 8192 x 48 blocks, recorded from device-drawn data; one
        # recording on disk at a time (8.5 GB). Writing one runs only the
        # plain versions. Each path's counts are set to 0 just before each
        # of its CLI runs and read just after.
        runs = {"wire": (3, [("power", [], 0),
                             ("power", ["--nspectra", "64"], 1),
                             ("stokes", ["--stokes"], 2),
                             ("stokes", ["--stokes", "--nspectra", "64"], 3),
                             ("pfb", ["--pfb", "128"], 4),
                             ("pfb", ["--pfb", "1024", "--stokes",
                                      "--nspectra", "8"], 5)]),
                "rows": (2, [("power", [], 0), ("stokes", ["--stokes"], 1),
                             ("pfb", ["--pfb", "128"], 2)])}
        main_stats = []
        ring_modes = {"wire": [(), ("--pfb", "1024", "--stokes",
                                    "--nspectra", "8")], "rows": [()]}
        pfb_cli_err = 0.0
        path_launches = {path: collections.Counter() for path in CLI_PATHS}
        multi_launches = collections.Counter()
        multi_lines = []
        for layout, (nblocks, cli_runs) in runs.items():
            path = os.path.join(tmp, f"full-{layout}.dada")
            refs = write_full_recording(path, layout, nblocks, gen, dev)
            file_runs, multi_refs = {}, {}
            for kind, extra, which in cli_runs:
                pw = os.path.join(tmp, "full-power.dada")
                CP.launches.clear()
                st = run_cli(cli, ["-a", path, "-b", pw] + extra)
                path_launches[kind].update(CP.launches)
                main_stats.append((layout, extra, st))
                hdr, recs = read_records(pw, tuple(refs[0][which].shape))
                if tuple(extra) in ring_modes[layout]:
                    file_runs[tuple(extra)] = (hdr, recs)
                if any(tuple(extra) == run[3]
                       for run in MULTI_RUNS[layout]):
                    multi_refs[tuple(extra)] = recs
                check(hdr["NPOL"] == ("4" if "--stokes" in extra else "1"),
                      f"full {layout} {extra}: header NPOL {hdr['NPOL']}")
                check(len(recs) == nblocks,
                      f"full {layout} {extra}: one record per block")
                for i, (rec, ref) in enumerate(zip(recs, refs)):
                    if kind != "pfb":
                        check(np.array_equal(rec, ref[which]),
                              f"full {layout} {extra}: record bit-equal to "
                              "the plain version")
                        continue
                    nfft = int(extra[1])
                    check(hdr["PFB_NFFT"] == str(nfft) and hdr.get_int(
                        "NCHAN") == NCHK * 7 * nfft,
                          f"full {layout} {extra}: PFB header")
                    e = peak_err(torch.from_numpy(np.array(rec)),
                                 torch.from_numpy(ref[which]))
                    check(e[1] < BOUND_PFB,
                          f"full {layout} {extra} block {i}: {e[1]:.3e} "
                          "peak-normalized against the plain streaming "
                          "version")
                    pfb_cli_err = max(pfb_cli_err, e[1])
            # 8a. the same modes through the launcher's ring topology
            log(f"[8a] {layout}: {host_memory()}")
            topology += ring_phase(layout, path, file_runs, tmp, smi)
            del file_runs
            # 9a-b. the multi-device runtime on the same recording
            log(f"[9] {layout}: {host_memory()}")
            multi_lines += multi_phase(layout, path, multi_refs, tmp, smi,
                                       multi_launches)
            del multi_refs
            os.remove(path)
        for kind in CLI_PATHS:
            for name in PATHS[kind]:
                check(path_launches[kind][name] > 0,
                      f"{kind} main path launched {name}")
    for layout, extra, st in main_stats:
        log(f"[5b] CLI 8192 x 48 {layout} {' '.join(extra)}: "
            f"{st['nblocks']} blocks in {st['elapsed_sec']:.3f} s, "
            f"{st['realtime_x']:.3f}x real time, "
            f"{st['kernel_launches']} kernel launches")
    for kind in CLI_PATHS:
        log(f"[5b] launches over the full-size {kind} path: "
            f"{dict(path_launches[kind])}")
    log(f"[5b] PFB records across block boundaries within {pfb_cli_err:.3e} "
        "(peak-normalized) of the plain streaming version")
    for line in topology + multi_lines:
        log(line)
    log(f"[9] launches over the multi-device path: {dict(multi_launches)}")
    for name in MULTI_KERNELS:
        check(multi_launches[name] > 0,
              f"the multi-device path launched {name}")

    # --- 6. timing at 8192 x 48 ----------------------------------------------
    gen.manual_seed(7)
    big = torch.randint(-32768, 32768, (FULL_NDF, NCHK * P.LANES_PER_CHUNK),
                        dtype=torch.int16, device=dev, generator=gen)
    big_rows = big.view(NCHK * 14, FULL_NDF, P.ROW_LANES)
    nchan = NCHK * 7
    n16 = big.numel()
    timed = {   # name: (kernel, plain, output floats, operations per int16)
        "baseband2power_cuda": (
            lambda: CP.baseband2power_cuda(big),
            lambda: P.baseband2power_2d(big), nchan, 2),
        "baseband2power_scrunch_cuda": (
            lambda: CP.baseband2power_scrunch_cuda(big, 64),
            lambda: P.baseband2power_scrunch_2d(big, 64), 64 * nchan, 2),
        "baseband2power_scrunch_rows_cuda": (
            lambda: CP.baseband2power_scrunch_rows_cuda(big_rows, 1),
            lambda: P.baseband2power_scrunch_rows(big_rows, 1), nchan, 2),
        "baseband2stokes_cuda": (
            lambda: CP.baseband2stokes_cuda(big),
            lambda: P.baseband2stokes_2d(big), 4 * nchan, 4),
        "baseband2stokes_scrunch_cuda": (
            lambda: CP.baseband2stokes_scrunch_cuda(big, 64),
            lambda: P.baseband2stokes_scrunch_2d(big, 64), 64 * 4 * nchan, 4),
        "baseband2stokes_scrunch_rows_cuda": (
            lambda: CP.baseband2stokes_scrunch_rows_cuda(big_rows, 1),
            lambda: P.baseband2stokes_scrunch_rows(big_rows, 1), 4 * nchan,
            4),
    }
    pfb_timed = [   # (wrapper, case, kernel, float32 plain, nfft, Stokes,
                    # spectra)
        ("pfb_power_cuda", "nfft 128 power",
         lambda: CF.pfb_power_cuda(big, 128, 4),
         lambda: PF.pfb_power(big, 128, 4), 128, False, 1),
        ("pfb_spectra_cuda", "nfft 1024 Stokes",
         lambda: CF.pfb_spectra_cuda(big, 1024, 4, stokes=True),
         lambda: PF.pfb_spectra(big, 1024, 4, stokes=True), 1024, True, 1),
        ("pfb_power_cuda", "nfft 1024 power",
         lambda: CF.pfb_power_cuda(big, 1024, 4),
         lambda: PF.pfb_power(big, 1024, 4), 1024, False, 1),
        ("pfb_spectra_cuda", "nfft 128 Stokes",
         lambda: CF.pfb_spectra_cuda(big, 128, 4, stokes=True),
         lambda: PF.pfb_spectra(big, 128, 4, stokes=True), 128, True, 1),
        ("pfb_spectra_cuda", "nfft 128 power x 64 spectra",
         lambda: CF.pfb_spectra_cuda(big, 128, 4, nout=64),
         lambda: PF.pfb_spectra(big, 128, 4, nout=64), 128, False, 64),
    ]
    gb = big.numel() * 2 / 1e9
    kernels = []
    phase6 = {}     # phase 10's reference: wrapper (and PFB case) -> ms
    for name, (kern, plain, nout_f, ops) in timed.items():
        # plain, kernel, kernel, plain: both measured in the same window
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        phase6[name] = ms
        bound_ms, bound_by = bound(n16 * 2 + nout_f * 4, n16 * ops)
        log(f"[6] {name}: {ms:.4f} ms/block ({gb / ms * 1e3:.1f} GB/s), "
            f"plain {plain_ms:.4f} ms/block ({gb / plain_ms * 1e3:.1f} "
            f"GB/s), bound {bound_ms:.4f} ms ({bound_by}) on {smi}")
        source, replaces = KERNELS[name]
        kind = "stokes" if "stokes" in name else "power"
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces,
            "launches": path_launches[kind][name],
            "launches_multidevice": multi_launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    for name, case, kern, plain, nfft, stokes, nout in pfb_timed:
        p1 = cuda_ms(plain, 2)
        k1 = cuda_ms(kern, 5)
        k2 = cuda_ms(kern, 5)
        p2 = cuda_ms(plain, 2)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        phase6[f"{name} ({case})"] = ms
        bound_ms, bound_by = bound(
            n16 * 2 + nout * (4 if stokes else 1) * nchan * nfft * 4,
            pfb_ops(n16 // 2, nfft, 4, stokes))
        log(f"[6] {name} ({case}): {ms:.4f} ms/block ({gb / ms * 1e3:.1f} "
            f"GB/s), plain float32 {plain_ms:.4f} ms/block, bound "
            f"{bound_ms:.4f} ms ({bound_by}) on {smi}")
        if any(k["name"] == name for k in kernels):
            continue
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "case": case,
            "launches": path_launches["pfb"][name],
            "launches_multidevice": multi_launches[name],
            "max_abs_err": pfb_err[name][0],
            "max_err_peak_normalized": pfb_err[name][1],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    del big, big_rows

    # --- 7. the spectrometer probes (K11-K13) ------------------------------
    kernels += [dict(k, launches_multidevice=0)
                for k in probe_phase(dev, gen, smi)]

    # --- 8c. the soak: live capture -> ring -> CUDA compute ------------------
    torch.cuda.empty_cache()
    soak_phase(smi)

    # --- 10. the bench ------------------------------------------------------
    bench_launches = bench_phase(phase6, smi)
    for k in kernels:
        k["launches_bench"] = bench_launches[k["name"]]
    check(sorted(k["name"] for k in kernels) == sorted(KERNELS),
          "one record per wrapper")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0].startswith("jax")
                    or m.split(".")[0] == REFERENCE)
    check(not loaded, f"nothing of jax or of the JAX package imported: "
          f"{loaded}")

    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def host_memory() -> str:
    """Free bytes of /dev/shm (where the rings live) and MemAvailable."""
    st = os.statvfs("/dev/shm")
    with open("/proc/meminfo") as f:
        avail = next(line.split(":")[1].strip() for line in f
                     if line.startswith("MemAvailable"))
    return (f"/dev/shm free {st.f_bavail * st.f_frsize} B, MemAvailable "
            f"{avail}")


def stage_env() -> dict:
    """The environment of the port's entry points run as processes: the
    checkout on the import path."""
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def run_launcher(path: str, ndf: int, extra: list[str], tmp: str,
                 name: str, mode: str = "ring") -> dict:
    """The port's launcher (``cli/launcher.py``) on the recording at
    ``path``, ``--platform cuda``, from an INI with uuid ring keys
    (``DiskdbConf NBLK 2``, ``Baseband2powerConf NBLK 4``): diskdb -> ring
    -> compute -> ring -> dbdisk. Fails if it exits non-zero or leaves a
    ring behind, and, in ring mode, if the compute stage's log shows no
    kernel launch. Returns its output directory, wall time and the compute
    stage's ``pipeline done`` line."""
    import re
    import uuid

    out = os.path.join(tmp, f"launcher-{name}")
    os.makedirs(out)
    keys = [uuid.uuid4().hex[:8] for _ in range(2)]
    conf = os.path.join(out, "pipeline.conf")
    with open(conf, "w") as f:
        f.write(f"[BasicConf]\nNCHK_NIC: {NCHK}\n[DiskdbConf]\nNDF: {ndf}\n"
                f"NBLK: 2\nKEY: {keys[0]}\n[Baseband2powerConf]\n"
                f"KEY: {keys[1]}\nNBLK: 4\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu_torch.cli.launcher",
         "-c", conf, "-a", path, "-b", out, "-o", "out.dada", "--mode", mode,
         "--platform", "cuda"] + extra,
        env=stage_env(), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"launcher {name} exit code {r.returncode}: "
          f"{r.stderr[-3000:]}")
    left = [k for k in keys if os.path.exists(f"/dev/shm/pafb2p-{k}")]
    check(not left, f"launcher {name}: rings {left} left behind")
    res = {"dir": out, "wall": wall, "done": ""}
    if mode == "ring":
        with open(os.path.join(out, "baseband2power.log")) as f:
            done = [line.split("] ", 2)[-1].strip() for line in f
                    if "pipeline done" in line]
        m = re.search(r"(\d+) kernel launches", done[-1] if done else "")
        check(m is not None and int(m.group(1)) > 0,
              f"launcher {name}: the compute stage launched kernels "
              f"({done})")
        res.update(done=done[-1], launches=int(m.group(1)),
                   stages=stage_times(out))
    return res


def stage_times(out: str) -> str:
    """Seconds from the launch of the stages to each block ``paf_diskdb``
    committed, to the compute stage's warm-up, its pipeline start and its
    end, from the stages' logs in ``out``."""
    import datetime

    def stamps(name, what):
        with open(os.path.join(out, name)) as f:
            return [datetime.datetime.strptime(line[1:24],
                                               "%Y-%m-%d %H:%M:%S,%f")
                    for line in f if what in line]

    t0 = stamps("pipeline.log", "launch diskdb")[-1]
    times = {"diskdb blocks": stamps("paf_diskdb.log", "-> ring")}
    for what in ("warmup", "pipeline start", "pipeline done"):
        times[f"compute {what}"] = stamps("baseband2power.log", what)[-1:]
    return "; ".join(
        f"{what} {', '.join(f'{(t - t0).total_seconds():.3f}' for t in ts)}"
        for what, ts in times.items()) + " s after the stages' launch"


def dada_payload(path: str, nbytes: int) -> tuple[dict, list[bytes]]:
    from paf_baseband2power_tpu_torch.io.dada import DadaFileReader

    with DadaFileReader(path) as r:
        return r.header, list(r.blocks(nbytes))


def ring_phase(layout: str, path: str, file_runs: dict, tmp: str,
               smi: str) -> list[str]:
    """Phase 8a on one of phase 5b's full-size recordings, while it is on
    disk: the launcher in ring mode for each mode phase 5b ran through the
    CLI in file mode (``file_runs``: flags -> (header, records)); every
    record byte-equal and the header equal. Returns its log lines."""
    lines = []
    for extra, (file_hdr, file_recs) in file_runs.items():
        name = f"{layout}{'-'.join([''] + list(extra))}"
        res = run_launcher(path, FULL_NDF, list(extra), tmp, name)
        shape = file_recs[0].shape
        hdr, recs = read_records(os.path.join(res["dir"], "out.dada"), shape)
        check(hdr == file_hdr, f"ring {name}: header equal to file mode's")
        check(len(recs) == len(file_recs)
              and all(a.tobytes() == b.tobytes()
                      for a, b in zip(recs, file_recs)),
              f"ring {name}: {len(recs)} records byte-equal to file mode's "
              f"{len(file_recs)}")
        lines.append(f"[8a] launcher --mode ring 8192 x 48 {layout} "
                     f"{' '.join(extra) or 'power'}: {len(recs)} records "
                     f"byte-equal to file mode, header equal; {res['wall']:.3f}"
                     f" s wall; compute stage: {res['done']}; "
                     f"{res['stages']} on {smi}")
        shutil.rmtree(res["dir"])
    return lines


def spill_phase(path: str, ndf: int, file_out: str, tmp: str,
                smi: str) -> list[str]:
    """Phase 8b on phase 5a's 3 x 1024 x 48 wire recording: the launcher
    with ``--raw-spill`` (NREADER 2), the spilled payload byte-equal to the
    recording's; then ``--mode file``, its records byte-equal to the CLI's
    (``file_out``)."""
    nbytes = ndf * NCHK * 7168
    res = run_launcher(path, ndf, ["--raw-spill", "raw.dada"], tmp, "spill")
    hdr, raw = dada_payload(os.path.join(res["dir"], "raw.dada"), nbytes)
    want_hdr, want = dada_payload(path, nbytes)
    check(hdr == want_hdr and len(raw) == len(want) == 3 and raw == want,
          "raw spill: header and payload byte-equal to the recording")
    lines = [f"[8b] launcher --raw-spill 1024 x 48: 3 blocks spilled "
             f"byte-equal to the recording, {res['wall']:.3f} s wall; "
             f"compute stage: {res['done']}"]
    resf = run_launcher(path, ndf, [], tmp, "file", mode="file")
    got = dada_payload(os.path.join(resf["dir"], "out.dada"), NCHK * 7 * 4)
    check(got == dada_payload(file_out, NCHK * 7 * 4),
          "launcher --mode file: records and header equal to the CLI's")
    lines.append(f"[8b] launcher --mode file 1024 x 48: 3 records byte-equal "
                 f"to the CLI's, {resf['wall']:.3f} s wall on {smi}")
    for d in (res["dir"], resf["dir"]):
        shutil.rmtree(d)
    return lines


def multi_phase(layout: str, path: str, refs: dict, tmp: str, smi: str,
                launches: collections.Counter) -> list[str]:
    """Phase 9a-b on one of phase 5b's full-size recordings, while it is on
    disk: ``paf_multihost --platform cuda`` for each of ``MULTI_RUNS``,
    its ranks as processes (``PAFB2P_*`` bootstrap on a free localhost
    port), rank 0's records held against phase 5b's single-device CLI
    records of the same blocks (``refs``: flags -> records). Adds each
    rank's launches to ``launches``; returns the log lines."""
    import socket

    from paf_baseband2power_tpu_torch.probes._common import peak_err

    lines = []
    for world, backend, flags, ref_key, nbeam in MULTI_RUNS[layout]:
        out = os.path.join(tmp, "multi.dada")
        logs = os.path.join(tmp, "multi-logs")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        argv = [sys.executable, "-m",
                "paf_baseband2power_tpu_torch.cli.paf_multihost",
                "-a", ",".join([path] * nbeam), "--nbeam", str(nbeam),
                "--ndf", str(FULL_NDF), "--nchk", str(NCHK), *flags,
                "--platform", "cuda", "--dist-backend", backend,
                "--stats-json", "-c", logs]
        env = stage_env()
        t0 = time.perf_counter()
        procs = []
        for rank in range(world):
            if world > 1:
                env = dict(env, PAFB2P_COORDINATOR=f"127.0.0.1:{port}",
                           PAFB2P_NUM_PROCS=str(world),
                           PAFB2P_PROC_ID=str(rank))
            procs.append(subprocess.Popen(
                argv + (["-b", out] if rank == 0 else []), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        name = (f"world {world} {backend} {layout} --nbeam {nbeam} "
                f"{' '.join(flags) or 'power'}")
        for p, (o, e) in zip(procs, outs):
            check(p.returncode == 0, f"paf_multihost {name}: exit code "
                  f"{p.returncode}: {e[-3000:]}")
        stats = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        ran = collections.Counter()
        for st in stats:
            ran.update(st["launches"])
        check(sum(ran.values()) > 0 and all(st["nprocs"] == world
                                            and st["backend"] == backend
                                            for st in stats),
              f"paf_multihost {name}: {world} ranks on {backend} launched "
              f"kernels: {stats}")
        launches.update(ran)
        want = refs[ref_key]
        _, got = read_records(out, want[0].shape)
        check(len(got) == len(want) * nbeam,
              f"paf_multihost {name}: {len(got)} records for "
              f"{len(want)} blocks x {nbeam} beams")
        err = 0.0
        for k, rec in enumerate(got):
            ref = want[k // nbeam]
            if "--pfb" in flags:
                err = max(err, peak_err(torch.from_numpy(np.array(rec)),
                                        torch.from_numpy(np.array(ref)))[1])
            else:
                check(rec.tobytes() == ref.tobytes(),
                      f"paf_multihost {name}: record {k} bit-equal to the "
                      "single-device CLI's")
        check(err < BOUND_PFB, f"paf_multihost {name}: {err:.3e} "
              "peak-normalized against the single-device CLI")
        lines.append(
            f"[9{'a' if world == 1 else 'b'}] paf_multihost {name}: "
            f"{len(got)} records "
            + (f"within {err:.3e} (peak-normalized) of"
               if "--pfb" in flags else "bit-equal to")
            + f" the single-device CLI's; {wall:.3f} s wall, rank 0 set "
            f"up in {stats[0]['setup_sec']:.3f} s, streamed in "
            f"{stats[0]['elapsed']:.3f} s, {stats[0]['realtime_x']:.4f}x "
            f"real time, mesh {stats[0]['mesh']}, launches {dict(ran)} "
            f"on {smi}")
        os.remove(out)
        shutil.rmtree(logs, ignore_errors=True)
    return lines


def soak_phase(smi: str) -> list[dict]:
    """Phase 8c: ``paf_soak --platform cuda`` (capture over loopback ->
    ring -> CUDA compute) at full channel width, 48 chunks on 6 ports,
    1024 frames per block (cut from 8192 for loopback's rate), 8 blocks of
    ring (2.8 GB of /dev/shm), the native sender, at ``SOAK_RATE``: power
    and ``--pfb 128 --nspectra 64`` from ``--device-layout`` rows, the
    latter also through the sharded rows step (``--sharded-rows``, phase
    9c); then at
    rate 1.0 at ``tests/test_soak.py``'s real-time geometry (1024 x 2, one
    port). Each must pass with kernel launches on cuda:0, within three
    runs as the JAX package's soak tests allow (capture's fall-behind quit
    is itself probabilistic on a shared host). Returns the reports."""
    full = ["--nchk", str(NCHK), "--nports", "6", "--ndf", "1024",
            "--nblk", "8", "--device-layout", "--seconds", "10",
            "--rate", str(SOAK_RATE)]
    reports = []
    for name, args in (("power", full),
                       ("pfb", full + ["--pfb", "128", "--nspectra", "64"]),
                       ("sharded-rows pfb", full + [
                           "--pfb", "128", "--nspectra", "64",
                           "--sharded-rows"]),
                       ("1024 x 2", ["--ndf", "1024", "--nchk", "2",
                                     "--nports", "1", "--nblk", "8",
                                     "--seconds", "5", "--rate", "1.0"])):
        for attempt in range(3):
            log(f"[8c] soak {name}, run {attempt + 1}: {host_memory()}")
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m",
                 "paf_baseband2power_tpu_torch.cli.paf_soak",
                 "--platform", "cuda", "--port-base", str(29100 + 10 * attempt)]
                + args, env=stage_env(), capture_output=True, text=True,
                timeout=300)
            wall = time.perf_counter() - t0
            report = (json.loads(r.stdout.strip().splitlines()[-1])
                      if r.stdout.strip() else {})
            log(f"[8c] soak {name} ({' '.join(args)}): exit {r.returncode}, "
                f"{wall:.3f} s wall, on {smi}: {json.dumps(report)}")
            ok = (r.returncode == 0 and report.get("pass") is True
                  and report.get("kernel_launches", 0) > 0
                  and report.get("backend") == "cuda:0"
                  and ("--sharded-rows" not in args
                       or report["mode"].endswith("[sharded-rows]")))
            if ok:
                break
        check(ok, f"soak {name} passes with kernel launches on cuda:0 "
              f"within 3 runs: {r.stderr[-3000:]}")
        reports.append(report)
    return reports


def bench_phase(phase6: dict, smi: str) -> collections.Counter:
    """Phase 10: each of ``BENCH_RUNS`` as a process, its JSON line printed
    and checked (keys, value, card, the one wrapper each mode launched, its
    time against phase 6's); returns the launches of all runs by
    wrapper."""
    launched = collections.Counter()
    for argv, ref in BENCH_RUNS:
        what = " ".join(argv) or "(the matrix)"
        if "--e2e" in argv:
            log(f"[10] bench {what}: {host_memory()}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "paf_baseband2power_tpu_torch.bench",
             *argv], env=stage_env(), capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"bench {what} exit code {r.returncode}: "
              f"{r.stderr[-3000:]}")
        out = r.stdout.strip().splitlines()
        check(len(out) == 1, f"bench {what} printed one line: {out}")
        line = json.loads(out[0])
        log(f"[10] bench {what}: {wall:.3f} s wall; {r.stderr.strip()}")
        log(out[0])
        kind = ("h2d" if "--h2d" in argv else "e2e" if "--e2e" in argv
                else "single" if argv else "matrix")
        check(set(line) == BENCH_KEYS[kind],
              f"bench {what} keys {sorted(line)}")
        check(line["value"] > 0, f"bench {what}: value {line['value']}")
        check(line["device"]["nvidia_smi"] == smi,
              f"bench {what} ran on {line['device']}")
        if kind == "h2d":
            check(line["pinned_bytes_per_sec"] > 0, f"bench {what} pinned")
            continue
        if kind == "e2e":
            # PowerPipeline's default step: direct power on wire blocks
            check(line["nblocks"] == 16 and line["wrappers"]
                  == {"baseband2power_cuda": line["kernel_launches"]},
                  f"bench {what}: 16 blocks, each a baseband2power_cuda "
                  f"launch: {line['wrappers']}")
            launched.update(line["wrappers"])
            continue
        if kind == "matrix":
            rows = line["matrix"]
            check([row["mode"] for row in rows] == list(BENCH_MATRIX),
                  f"bench matrix modes {[row['mode'] for row in rows]}")
            check(all(set(row) == BENCH_KEYS["row"] for row in rows),
                  "bench matrix rows' keys")
            rows = [(row, row["mode"], *BENCH_MATRIX[row["mode"]])
                    for row in rows]
        else:
            rows = [(line, what, *ref)]
        for row, mode, ref, same in rows:
            # the torch.fft route only where the label names it; else one
            # CUDA wrapper, and the same one as phase 6's same-shape time
            fft = "torch.fft" in line["metric"]
            check(len(row["wrappers"]) == 1 and row["launches"] > 0
                  and row["launches"] == sum(row["wrappers"].values()),
                  f"bench {mode} launched one wrapper: {row['wrappers']}")
            wrapper, = row["wrappers"]
            check((wrapper == "pfb_torch") if fft else (wrapper in KERNELS),
                  f"bench {mode} launched {wrapper}, torch.fft named: {fft}")
            check(not same or ref.split()[0] == wrapper,
                  f"bench {mode} launched {wrapper}, phase 6 timed {ref}")
            launched.update(row["wrappers"])
            if ref is None:
                log(f"[10] {mode}: {row['block_ms']:.4f} ms/block, "
                    f"launches {row['wrappers']}; no phase 6 time")
                continue
            ratio = row["block_ms"] / phase6[ref]
            log(f"[10] {mode}: {row['block_ms']:.4f} ms/block "
                f"(hbm_fraction {row['hbm_fraction']:.4f}), launches "
                f"{row['wrappers']}; phase 6 {ref} {phase6[ref]:.4f} ms, "
                f"{ratio:.3f}x ({'the same shape' if same else 'nearest'}) "
                f"on {smi}")
            if same:
                check(0.5 <= ratio <= 2.0,
                      f"bench {mode} within 2x of phase 6's {ref}: "
                      f"{ratio:.3f}x")
    return launched


def run_main(fn, argv: list[str]) -> dict:
    """Run a probe's ``main`` in this process; returns its JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    check(rc == 0, f"{fn.__module__} {argv} exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def probe_phase(dev: torch.device, gen: torch.Generator,
                smi: str) -> list[dict]:
    """Phase 7: the probe kernels against their plain versions, their
    times, and the probes path; returns their records of the kernels
    line."""
    from paf_baseband2power_tpu_torch.ops import _build
    from paf_baseband2power_tpu_torch.ops import cuda_power as CP
    from paf_baseband2power_tpu_torch.probes import karatsuba as K
    from paf_baseband2power_tpu_torch.probes import wide_reshape as W
    from paf_baseband2power_tpu_torch.probes._common import (KERNEL_SPLIT,
                                                             peak_err)

    f64 = torch.float64
    err = {name: [0.0, 0.0] for name in PATHS["probes"]}
    calls = collections.Counter()

    def hold(name, got, want, what, exact=False):
        calls[name] += 1
        e = peak_err(got, want)
        err[name] = [max(a, b) for a, b in zip(err[name], e)]
        if exact:
            check(torch.equal(got, want),
                  f"{what}: equal to the plain version")
        else:
            check(got.shape == want.shape and e[1] < BOUND_PFB,
                  f"{what}: {e[1]:.3e} peak-normalized against the float64 "
                  "plain version")

    def draw(nseries, ndf, seed):
        gen.manual_seed(seed)
        return torch.randint(-256, 256, (nseries, ndf, 256), dtype=torch.int16,
                             device=dev, generator=gen)

    # 7a. small sizes: 2 chunks (28 series), 128 and 64 frames
    CP.launches.clear()
    for ndf in (128, 64):
        rows = draw(28, ndf, ndf)
        for n1, R in ((1, 16), (2, 8), (8, 2), (8, 16)):
            for widen in (False, True):
                if ndf % (R * n1) == 0:
                    hold("micro_cuda", W.micro_cuda(rows, n1, R, widen),
                         W.micro(rows, n1, R, widen),
                         f"micro {ndf} frames n1={n1} R={R} widen={widen}",
                         exact=True)
        for nfft in (128, 256, 512, 1024):
            n1 = nfft // 128
            xp = W.to_planes(rows, n1)
            for ntap in (4, 8):
                for sa in W.STAGE_A:
                    if sa == "fft8" and n1 != 8:
                        continue
                    R = min(8, ndf // n1)
                    hold("planes_cuda", W.planes_cuda(xp, nfft, ntap, R, sa),
                         W.planes(xp, nfft, ntap, R, sa, dtype=f64),
                         f"planes {ndf} frames nfft={nfft} ntap={ntap} "
                         f"stage_a={sa}")
        for R in (ndf, 32, 16):
            hold("karatsuba_planar_cuda", K.karatsuba_planar_cuda(rows, R),
                 K.karatsuba_planar(rows, R, dtype=f64),
                 f"Karatsuba {ndf} frames R={R}")
    chk = K.check_rows()
    got = K.karatsuba_planar_cuda(torch.from_numpy(chk).to(dev), chk.shape[1])
    calls["karatsuba_planar_cuda"] += 1
    check_err = peak_err(got.cpu(), torch.from_numpy(K.planar_golden(chk)))[1]
    check(check_err < BOUND_PFB, f"Karatsuba --check input: {check_err:.3e} "
          "against the numpy golden")
    check(dict(CP.launches) == dict(calls),
          f"probe launch counters {dict(CP.launches)} match calls "
          f"{dict(calls)}")
    log(f"[7] probes at 28 x 128 and 28 x 64, {sum(calls.values())} cases: "
        f"micro equal, planes and Karatsuba within {BOUND_PFB} of float64 "
        f"(max abs, peak-normalized: {err}); Karatsuba --check "
        f"{check_err:.3e} against the numpy golden")

    # 7b. 8192 x 48: the probes' own range, drawn on the card
    rows = draw(NCHK * 14, FULL_NDF, 2026)
    nseries = rows.shape[0]
    xp = W.to_planes(rows, 8)
    nrow = FULL_NDF // 8
    for n1, R in ((8, 128), (1, 1024)):
        for widen in (False, True):
            hold("micro_cuda", W.micro_cuda(rows, n1, R, widen),
                 W.micro(rows, n1, R, widen),
                 f"micro 8192 x 48 n1={n1} R={R} widen={widen}", exact=True)
    for sa in W.STAGE_A:
        hold("planes_cuda", W.planes_cuda(xp, 1024, 4, 128, sa),
             W.planes(xp, 1024, 4, 128, sa, dtype=f64),
             f"planes 8192 x 48 nfft=1024 R=128 stage_a={sa}")
    for R in (1024, 2048):
        hold("karatsuba_planar_cuda", K.karatsuba_planar_cuda(rows, R),
             K.karatsuba_planar(rows, R, dtype=f64),
             f"Karatsuba 8192 x 48 R={R}")
    log(f"[7] probes at 8192 x 48: micro equal, planes (every stage_a) and "
        f"Karatsuba (R 1024, 2048) within {BOUND_PFB} of float64 (max abs, "
        f"peak-normalized: {err})")

    # timing: plain (float32), kernel, kernel, plain
    nbytes = rows.numel() * 2
    tile = 8 * 128

    def last_tile_sum():
        return rows[:, -tile:].sum(dim=1, dtype=torch.float32)

    check(torch.equal(last_tile_sum()[:, None], W.micro_cuda(rows, 8, 128)),
          "torch.sum over the last tile equals micro")
    kar_least, kar_products = karatsuba_ops(nseries, FULL_NDF, 4)
    timed = [   # (wrapper, case, kernel, plain, library call, bound)
        ("micro_cuda", "n1 8, R 128 (nfft 1024 tiles), narrow",
         lambda: W.micro_cuda(rows, 8, 128), lambda: W.micro(rows, 8, 128),
         last_tile_sum, bound(nbytes + nseries * 256 * 4, rows.numel())),
        ("micro_cuda", "n1 8, R 128, widen",
         lambda: W.micro_cuda(rows, 8, 128, True),
         lambda: W.micro(rows, 8, 128, True), last_tile_sum,
         bound(nbytes + nseries * 256 * 4, rows.numel())),
        ("micro_cuda", "n1 1, R 1024 (nfft 128 tiles), narrow",
         lambda: W.micro_cuda(rows, 1, 1024), lambda: W.micro(rows, 1, 1024),
         None, bound(nbytes + nseries * 256 * 4, rows.numel())),
    ]
    for sa in W.STAGE_A:
        timed.append((
            "planes_cuda", f"nfft 1024, R 128, stage_a {sa}",
            lambda sa=sa: W.planes_cuda(xp, 1024, 4, 128, sa),
            lambda sa=sa: W.planes(xp, 1024, 4, 128, sa), None,
            bound(nbytes + nseries * 1024 * 4,
                  planes_ops(nseries, nrow, 1024, 4, sa))))
    for R in (1024, 2048):
        timed.append((
            "karatsuba_planar_cuda", f"R {R}",
            lambda R=R: K.karatsuba_planar_cuda(rows, R),
            lambda R=R: K.karatsuba_planar(rows, R), None,
            bound(nbytes + nseries * 128 * 4, kar_least)))
    gb = nbytes / 1e9
    records = []
    for name, case, kern, plain, library, (bound_ms, bound_by) in timed:
        quick = name == "micro_cuda"
        p1 = cuda_ms(plain, 5 if quick else 2)
        k1 = cuda_ms(kern, 20 if quick else 5)
        k2 = cuda_ms(kern, 20 if quick else 5)
        p2 = cuda_ms(plain, 5 if quick else 2)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        library_ms = cuda_ms(library, 20) if library else None
        log(f"[7] {name} ({case}): {ms:.4f} ms/block ({gb / ms * 1e3:.1f} "
            f"GB/s), plain float32 {plain_ms:.4f} ms/block, library "
            f"{library_ms if library_ms is None else f'{library_ms:.4f}'} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}) on {smi}")
        if any(r["name"] == name for r in records):
            continue
        source, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "case": case,
            "max_abs_err": err[name][0],
            "max_err_peak_normalized": err[name][1],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    # the tensor-core kernels' own floor: their products at 3xBF16
    planes_products = nseries * (nrow - 3) * 8 * 3 * 2 * 128 * 128
    for r in records:
        products = {"karatsuba_planar_cuda": kar_products,
                    "planes_cuda": planes_products}.get(r["name"])
        if products:
            r["split"] = KERNEL_SPLIT
            floor_ms = 3 * products / BF16_FLOPS * 1e3
            log(f"[7] {r['name']}: three products of {products / 1e9:.1f} "
                f"GFLOP at {KERNEL_SPLIT} take {floor_ms:.4f} ms "
                f"on the tensor cores ({BF16_FLOPS / 1e12:.0f} TFLOP/s); the "
                f"function's least (Karatsuba {kar_least / 1e9:.1f} GFLOP) "
                f"{kar_least / FP32_FLOPS * 1e3:.4f} ms on the fp32 cores")
    # two calls of each redesigned kernel on the same block are bit-equal
    for name, call in (("karatsuba_planar_cuda R 1024",
                        lambda: K.karatsuba_planar_cuda(rows, 1024)),
                       ("planes_cuda nfft 1024 full",
                        lambda: W.planes_cuda(xp, 1024, 4, 128, "full"))):
        check(torch.equal(call(), call()), f"{name}: two calls bit-equal")
    # what the redesigned kernels compiled to: ptxas and tensor-core SASS
    lib_path = _build.build()
    for line in ptxas_lines(_build.ptxas_report(lib_path)):
        if line.startswith(("probe_karatsuba.cu", "probe_planes.cu")):
            log(f"[7] ptxas {line}")
    counts = _build.tensor_core_counts(lib_path)
    for kernel, n in counts.items():
        if "karatsuba_kernel" in kernel or "planes_kernel" in kernel:
            log(f"[7] sass {kernel}: {n['HMMA']} HMMA, {n['HGMMA']} HGMMA")
    for kernel, mangled in (("karatsuba_kernel", "karatsuba_kernel"),
                            ("planes_kernel<8>", "planes_kernelILi8E")):
        found = [n for k, n in counts.items() if mangled in k]
        check(bool(found) and all(n["HMMA"] + n["HGMMA"] > 0 for n in found),
              f"{kernel} is in the SASS and runs its products on the "
              f"tensor cores: {found}")
    del rows, xp
    torch.cuda.empty_cache()

    # 7c. the probes path: both probes' main at full size
    CP.launches.clear()
    wide = run_main(W.main, ["--iters", "3"])
    kar = run_main(K.main, ["--iters", "3"])
    launched = collections.Counter(CP.launches)
    for name in PATHS["probes"]:
        check(launched[name] > 0, f"probes path launched {name}")
    check(wide["parity_ok_full"] and wide["parity_ok_fft8"],
          f"planes parity: {wide}")
    check(all(isinstance(v, float) for v in wide["results"].values()),
          f"every wide_reshape variant ran: {wide['results']}")
    check(set(kar["ms"]) == {"karatsuba R=1024", "karatsuba R=2048",
                             "interleaved production"}
          and all(isinstance(v, float) for v in kar["ms"].values()),
          f"every Karatsuba case ran: {kar['ms']}")
    log(f"[7] probes path, wide_reshape: {json.dumps(wide)}")
    log(f"[7] probes path, karatsuba: {json.dumps(kar)}")
    log(f"[7] launches over the probes path: {dict(launched)}")
    for r in records:
        r["launches"] = launched[r["name"]]
    return records


if __name__ == "__main__":
    sys.exit(main())
