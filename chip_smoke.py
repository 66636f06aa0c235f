#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. environment: device, ``nvidia-smi`` name and power limit, nvcc, torch;
  2. build the CUDA kernels from ``paf_baseband2power_tpu_torch/csrc``;
  3. power and Stokes kernels vs the float64 golden model at 256 x 48
     (nout 1/8/256) and 200 x 48 (nout 1/2), wire and rows, mean on and
     off: bit-equal; the PFB kernel vs its plain version in float64 at the
     same two sizes (nfft 32/128/256/1024, ntap 1/4/8, nout 1 and more,
     power and Stokes, mean on and off, wire and rows, with and without a
     carry): within 2e-5, peak-normalized;
  4. kernels vs their plain PyTorch versions at the production 8192 x 48
     block, full-range int16 drawn on the device, an all -32768 block and,
     for Stokes, a block whose y is x turned by 90 degrees (V = -I):
     bit-equal; the PFB kernel at nfft 128 and 1024, power and Stokes,
     nout 1 and 64, vs its plain version in float64: within 2e-5;
  5. the main paths through the port's CLI: recordings written with
     ``paf_gen`` (1024 x 48, wire and ORDER SERIES) checked against the
     golden model, then recordings of full 8192 x 48 blocks checked
     against the plain versions: the power path (wire, wire x 64 spectra,
     ORDER SERIES), the Stokes path (the same three with ``--stokes``,
     NPOL 4 headers) and the PFB path (``--pfb 128`` and ``--pfb 1024
     --stokes --nspectra 8`` on the wire recording, ``--pfb 128`` on the
     rows one; their blocks cross carry boundaries, and every record is
     held against the plain streaming version in float64 within 2e-5),
     with each path's launch counts set to 0 before each of its runs and
     read after;
  6. ms per block of each kernel and of its plain version at 8192 x 48
     (CUDA events, after a warm-up; the PFB's plain version in float32).
The last two lines are the kernels' JSON record and the result line.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_NDF, NCHK = 8192, 48
CSRC = "paf_baseband2power_tpu_torch/csrc/"
PALLAS = "paf_baseband2power_tpu/ops/pallas_power.py"
PALLAS_PFB = "paf_baseband2power_tpu/ops/pallas_pfb.py"
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
}
PATHS = {"power": [k for k in KERNELS if k.startswith("baseband2power")],
         "stokes": [k for k in KERNELS if k.startswith("baseband2stokes")],
         "pfb": [k for k in KERNELS if k.startswith("pfb")]}
# PFB cases of phase 3: nfft, ntap, nout, stokes, mean (each on wire, on
# rows for nfft 128 and 1024, with and without a carry, where the frame
# count allows the shape)
PFB_CASES = [(32, 4, 1, False, False), (32, 8, 8, True, True),
             (128, 1, 1, False, True), (128, 4, 4, True, False),
             (128, 8, 2, False, True), (128, 4, 64, True, True),
             (256, 4, 1, True, True), (256, 8, 4, False, False),
             (1024, 4, 1, False, False), (1024, 8, 2, True, True),
             (1024, 1, 1, True, False)]


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


def peak_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / peak of ``want``)."""
    d = (got.double() - want.double()).abs().max().item()
    return d, d / want.double().abs().max().item()


def run_pfb(blk, nfft, ntap, nout, stokes, mean, carry, layout):
    """The PFB kernel (``pfb_power_cuda`` for nout 1 power, else
    ``pfb_spectra_cuda``) and its plain version in float64 on one block;
    returns ``(wrapper name, kernel result, plain result)``."""
    from paf_baseband2power_tpu_torch.ops import cuda_pfb as CF
    from paf_baseband2power_tpu_torch.ops import pfb as PF

    kw = dict(mean=mean, history=carry, layout=layout)
    if nout == 1 and not stokes:
        return ("pfb_power_cuda", CF.pfb_power_cuda(blk, nfft, ntap, **kw),
                PF.pfb_power(blk, nfft, ntap, dtype=torch.float64, **kw))
    kw.update(nout=nout, stokes=stokes)
    return ("pfb_spectra_cuda", CF.pfb_spectra_cuda(blk, nfft, ntap, **kw),
            PF.pfb_spectra(blk, nfft, ntap, dtype=torch.float64, **kw))


def run_cli(cli, argv: list[str]) -> dict:
    """Run the port's CLI in this process; returns its --stats-json."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--stats-json"])
    check(rc == 0, f"CLI {argv} exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def read_records(path: str, shape: tuple) -> tuple[dict, list[np.ndarray]]:
    from paf_baseband2power_tpu.io.dada import DadaFileReader

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
    from paf_baseband2power_tpu.io.dada import DadaFileWriter, baseband_header
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
    sys.path.insert(0, ROOT)
    from paf_baseband2power_tpu.cli import paf_gen
    from paf_baseband2power_tpu.ops import frame as F
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_golden,
        baseband2power_scrunch_golden,
        baseband2stokes_golden,
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu_torch.cli import paf_baseband2power as cli
    from paf_baseband2power_tpu_torch.ops import _build
    from paf_baseband2power_tpu_torch.ops import cuda_power as CP
    from paf_baseband2power_tpu_torch.ops import power as P

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

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

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"[2] built {os.path.relpath(lib_path, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # --- 3. kernels vs the float64 golden at 256 x 48 (and 200 x 48) -----
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
        for mean in (False, True):
            want = baseband2power_golden(block, mean=mean)
            for name, got in (
                    ("wire", CP.baseband2power_cuda(wire, mean=mean)),
                    ("bytes", CP.baseband2power_cuda_bytes(raw, ndf, NCHK,
                                                           mean=mean))):
                check(np.array_equal(got.cpu().numpy(), want),
                      f"{ndf} frames {name} nout=1 mean={mean} bit-equal "
                      "to the golden")
            for nout in nouts:
                want = baseband2power_scrunch_golden(block, nout, mean=mean)
                for name, got in (
                        ("wire", CP.baseband2power_scrunch_cuda(
                            wire, nout, mean=mean)),
                        ("rows", CP.baseband2power_scrunch_rows_cuda(
                            rows, nout, mean=mean))):
                    check(np.array_equal(got.cpu().numpy(), want),
                          f"{ndf} frames {name} nout={nout} mean={mean} "
                          "bit-equal to the golden")
            want = baseband2stokes_golden(block, mean=mean)
            check(np.array_equal(
                CP.baseband2stokes_cuda(wire, mean=mean).cpu().numpy(),
                want), f"{ndf} frames Stokes wire mean={mean} bit-equal "
                "to the golden")
            for nout in nouts:
                want = baseband2stokes_scrunch_golden(block, nout, mean=mean)
                for name, got in (
                        ("wire", CP.baseband2stokes_scrunch_cuda(
                            wire, nout, mean=mean)),
                        ("rows", CP.baseband2stokes_scrunch_rows_cuda(
                            rows, nout, mean=mean))):
                    check(np.array_equal(got.cpu().numpy(), want),
                          f"{ndf} frames Stokes {name} nout={nout} "
                          f"mean={mean} bit-equal to the golden")
    counts = {path: sum(CP.launches[k] for k in PATHS[path])
              for path in ("power", "stokes")}
    check(counts == {"power": 28, "stokes": 24},
          f"launch counters rose by 28 (power) and 24 (Stokes): {counts}")
    log("[3] 256 x 48 (nout 1/8/256) and 200 x 48 (nout 1/2): power (wire, "
        "bytes, rows) and Stokes (wire, rows), mean off/on: bit-equal to the "
        "float64 golden")

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
            for layout in (("wire", "rows") if nfft in (128, 1024)
                           else ("wire",)):
                view = ((lambda t: t) if layout == "wire"
                        else (lambda t: t.view(NCHK * 14, ndf, 256)))
                for carry in (None,
                              PF.pfb_history(view(prev), nfft, ntap, layout)):
                    name, got, want = run_pfb(view(x), nfft, ntap, nout,
                                              stokes, mean, carry, layout)
                    calls[name] += 1
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
    log(f"[3] PFB 256 x 48 and 200 x 48, {sum(calls.values())} cases: "
        f"within {BOUND_PFB} of the float64 plain version (max abs, "
        f"peak-normalized: {pfb_err})")

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
    del big, big_rows, prev

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
                want = baseband2power_golden(
                    F.synthetic_block(rng=5 + i, ndf=ndf, nchk=NCHK))
                check(np.array_equal(rec, want),
                      f"{layout} record {i} bit-equal to the golden")
            os.remove(bb)
        log("[5a] CLI on paf_gen recordings 3 x 1024 x 48, wire and ORDER "
            "SERIES: every record bit-equal to the float64 golden")

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
        pfb_cli_err = 0.0
        path_launches = {path: collections.Counter() for path in PATHS}
        for layout, (nblocks, cli_runs) in runs.items():
            path = os.path.join(tmp, f"full-{layout}.dada")
            refs = write_full_recording(path, layout, nblocks, gen, dev)
            for kind, extra, which in cli_runs:
                pw = os.path.join(tmp, "full-power.dada")
                CP.launches.clear()
                st = run_cli(cli, ["-a", path, "-b", pw] + extra)
                path_launches[kind].update(CP.launches)
                main_stats.append((layout, extra, st))
                hdr, recs = read_records(pw, tuple(refs[0][which].shape))
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
            os.remove(path)
        for kind, names in PATHS.items():
            for name in names:
                check(path_launches[kind][name] > 0,
                      f"{kind} main path launched {name}")
    for layout, extra, st in main_stats:
        log(f"[5b] CLI 8192 x 48 {layout} {' '.join(extra)}: "
            f"{st['nblocks']} blocks in {st['elapsed_sec']:.3f} s, "
            f"{st['realtime_x']:.3f}x real time, "
            f"{st['kernel_launches']} kernel launches")
    for kind in PATHS:
        log(f"[5b] launches over the full-size {kind} path: "
            f"{dict(path_launches[kind])}")
    log(f"[5b] PFB records across block boundaries within {pfb_cli_err:.3e} "
        "(peak-normalized) of the plain streaming version")

    # --- 6. timing at 8192 x 48 ----------------------------------------------
    gen.manual_seed(7)
    big = torch.randint(-32768, 32768, (FULL_NDF, NCHK * P.LANES_PER_CHUNK),
                        dtype=torch.int16, device=dev, generator=gen)
    big_rows = big.view(NCHK * 14, FULL_NDF, P.ROW_LANES)
    timed = {
        "baseband2power_cuda": (
            lambda: CP.baseband2power_cuda(big),
            lambda: P.baseband2power_2d(big)),
        "baseband2power_scrunch_cuda": (
            lambda: CP.baseband2power_scrunch_cuda(big, 64),
            lambda: P.baseband2power_scrunch_2d(big, 64)),
        "baseband2power_scrunch_rows_cuda": (
            lambda: CP.baseband2power_scrunch_rows_cuda(big_rows, 1),
            lambda: P.baseband2power_scrunch_rows(big_rows, 1)),
        "baseband2stokes_cuda": (
            lambda: CP.baseband2stokes_cuda(big),
            lambda: P.baseband2stokes_2d(big)),
        "baseband2stokes_scrunch_cuda": (
            lambda: CP.baseband2stokes_scrunch_cuda(big, 64),
            lambda: P.baseband2stokes_scrunch_2d(big, 64)),
        "baseband2stokes_scrunch_rows_cuda": (
            lambda: CP.baseband2stokes_scrunch_rows_cuda(big_rows, 1),
            lambda: P.baseband2stokes_scrunch_rows(big_rows, 1)),
    }
    pfb_timed = [   # (wrapper, case, kernel, float32 plain)
        ("pfb_power_cuda", "nfft 128 power",
         lambda: CF.pfb_power_cuda(big, 128, 4),
         lambda: PF.pfb_power(big, 128, 4)),
        ("pfb_spectra_cuda", "nfft 1024 Stokes",
         lambda: CF.pfb_spectra_cuda(big, 1024, 4, stokes=True),
         lambda: PF.pfb_spectra(big, 1024, 4, stokes=True)),
        ("pfb_power_cuda", "nfft 1024 power",
         lambda: CF.pfb_power_cuda(big, 1024, 4),
         lambda: PF.pfb_power(big, 1024, 4)),
        ("pfb_spectra_cuda", "nfft 128 Stokes",
         lambda: CF.pfb_spectra_cuda(big, 128, 4, stokes=True),
         lambda: PF.pfb_spectra(big, 128, 4, stokes=True)),
        ("pfb_spectra_cuda", "nfft 128 power x 64 spectra",
         lambda: CF.pfb_spectra_cuda(big, 128, 4, nout=64),
         lambda: PF.pfb_spectra(big, 128, 4, nout=64)),
    ]
    gb = big.numel() * 2 / 1e9
    kernels = []
    for name, (kern, plain) in timed.items():
        # plain, kernel, kernel, plain: both measured in the same window
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"[6] {name}: {ms:.4f} ms/block ({gb / ms * 1e3:.1f} GB/s), "
            f"plain {plain_ms:.4f} ms/block ({gb / plain_ms * 1e3:.1f} "
            f"GB/s) on {smi}")
        source, replaces = KERNELS[name]
        kind = "stokes" if "stokes" in name else "power"
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces,
            "launches": path_launches[kind][name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
        })
    for name, case, kern, plain in pfb_timed:
        p1 = cuda_ms(plain, 2)
        k1 = cuda_ms(kern, 5)
        k2 = cuda_ms(kern, 5)
        p2 = cuda_ms(plain, 2)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"[6] {name} ({case}): {ms:.4f} ms/block ({gb / ms * 1e3:.1f} "
            f"GB/s), plain float32 {plain_ms:.4f} ms/block on {smi}")
        if any(k["name"] == name for k in kernels):
            continue
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "case": case,
            "launches": path_launches["pfb"][name],
            "max_abs_err": pfb_err[name][0],
            "max_err_peak_normalized": pfb_err[name][1],
            "ms": ms, "plain_ms": plain_ms,
        })
    check("jax" not in sys.modules, "no jax imported")

    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
