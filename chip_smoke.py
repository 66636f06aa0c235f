#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. environment: device, ``nvidia-smi`` name and power limit, nvcc, torch;
  2. build the CUDA kernels from ``paf_baseband2power_tpu_torch/csrc``;
  3. kernels vs the float64 golden model at 256 x 48 (nout 1/8/256) and
     200 x 48 (nout 1/2), wire and rows, mean on and off: bit-equal;
  4. kernels vs their plain PyTorch versions at the production 8192 x 48
     block, full-range int16 drawn on the device and an all -32768 block:
     bit-equal;
  5. the main path through the port's CLI: recordings written with
     ``paf_gen`` (1024 x 48, wire and ORDER SERIES) checked against the
     golden model, then recordings of full 8192 x 48 blocks (wire,
     wire x 64 spectra, ORDER SERIES) checked against the plain version,
     with the kernels' launch counts taken over that full-size run;
  6. ms per block of each kernel and of its plain version at 8192 x 48
     (CUDA events, after a warm-up).
The last two lines are the kernels' JSON record and the result line.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

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
SOURCE = "paf_baseband2power_tpu_torch/csrc/power.cu"
# wrapper -> the pl.pallas_call it replaces (K2's call; K3's at :290 is
# the same entry point's other tile branch)
REPLACES = {
    "baseband2power_cuda": "paf_baseband2power_tpu/ops/pallas_power.py:103",
    "baseband2power_scrunch_cuda":
        "paf_baseband2power_tpu/ops/pallas_power.py:250",
    "baseband2power_scrunch_rows_cuda":
        "paf_baseband2power_tpu/ops/pallas_power.py:776",
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


def run_cli(cli, argv: list[str]) -> dict:
    """Run the port's CLI in this process; returns its --stats-json."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--stats-json"])
    check(rc == 0, f"CLI {argv} exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def read_records(path: str, shape: tuple) -> list[np.ndarray]:
    from paf_baseband2power_tpu.io.dada import DadaFileReader

    with DadaFileReader(path) as r:
        nbytes = int(np.prod(shape)) * 4
        return [np.frombuffer(b, "<f4").reshape(shape)
                for b in r.blocks(nbytes)]


def write_full_recording(path: str, layout: str, nblocks: int,
                         gen: torch.Generator, dev: torch.device) -> list:
    """Write ``nblocks`` full-range 8192 x 48 blocks drawn on the card to a
    .dada recording (``ORDER SERIES`` for rows); returns each block's plain
    records: ``[power]`` for rows, ``[power, 64-window power]`` for wire."""
    from paf_baseband2power_tpu.io.dada import DadaFileWriter, baseband_header
    from paf_baseband2power_tpu_torch.ops import power as P

    extra = {"ORDER": "SERIES"} if layout == "rows" else None
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
                refs.append([P.baseband2power_scrunch_rows(rows, 1)[0]])
            else:
                refs.append([P.baseband2power_2d(x),
                             P.baseband2power_scrunch_2d(x, 64)])
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
    # 256 frames: nout 1/8/256 as in the issue's shapes; 200 frames: windows
    # of 200 and 100 frames end in a partial 64-frame slab and have mean
    # divisors that are not powers of two.
    n0 = sum(CP.launches.values())
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
    check(sum(CP.launches.values()) - n0 == 28, "launch counter rose by 28")
    log("[3] 256 x 48 (nout 1/8/256) and 200 x 48 (nout 1/2): wire, bytes "
        "and rows, mean off/on: bit-equal to the float64 golden")

    # --- 4. kernels vs plain versions at 8192 x 48 ------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    big = torch.randint(-32768, 32768, (FULL_NDF, NCHK * P.LANES_PER_CHUNK),
                        dtype=torch.int16, device=dev, generator=gen)
    big_rows = big.view(NCHK * 14, FULL_NDF, P.ROW_LANES)
    cases = {
        "baseband2power_cuda": lambda x: (
            CP.baseband2power_cuda(x), P.baseband2power_2d(x)),
        "baseband2power_scrunch_cuda": lambda x: (
            CP.baseband2power_scrunch_cuda(x, 64),
            P.baseband2power_scrunch_2d(x, 64)),
        "baseband2power_scrunch_rows_cuda": lambda x: (
            CP.baseband2power_scrunch_rows_cuda(
                x.view(big_rows.shape), 1),
            P.baseband2power_scrunch_rows(x.view(big_rows.shape), 1)),
    }
    err = {name: 0.0 for name in cases}
    for fill in ("random", "-32768"):
        if fill == "-32768":
            big.fill_(-32768)
        for name, fn in cases.items():
            got, want = fn(big)
            err[name] = max(err[name], (got - want).abs().max().item())
            check(torch.equal(got, want),
                  f"{name} ({fill}) bit-equal to the plain version")
        for nout in (1, 64):
            got = CP.baseband2power_scrunch_rows_cuda(big_rows, nout,
                                                      mean=True)
            want = P.baseband2power_scrunch_rows(big_rows, nout, mean=True)
            check(torch.equal(got, want),
                  f"rows nout={nout} mean ({fill}) bit-equal to plain")
    check(bool((got == 2.0 ** 31).all()),
          "all -32768 block: mean power 2 x 2^30 per channel sample")
    log(f"[4] 8192 x 48: random and all -32768 blocks, wire/rows, nout 1 "
        f"and 64: bit-equal to the plain versions (max abs err {err})")
    del big, big_rows

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
            recs = read_records(pw, (NCHK * 7,))
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
        # plain versions, so the counts are the CLI runs' alone.
        runs = {"wire": (3, [([], 0), (["--nspectra", "64"], 1)]),
                "rows": (2, [([], 0)])}
        main_stats = []
        CP.launches.clear()
        for layout, (nblocks, cli_runs) in runs.items():
            path = os.path.join(tmp, f"full-{layout}.dada")
            refs = write_full_recording(path, layout, nblocks, gen, dev)
            for extra, which in cli_runs:
                pw = os.path.join(tmp, "full-power.dada")
                st = run_cli(cli, ["-a", path, "-b", pw] + extra)
                main_stats.append((layout, extra, st))
                recs = read_records(pw, refs[0][which].shape)
                check(len(recs) == nblocks,
                      f"full {layout} {extra}: one record per block")
                for rec, ref in zip(recs, refs):
                    check(np.array_equal(rec, ref[which]),
                          f"full {layout} {extra}: record bit-equal to the "
                          "plain version")
            os.remove(path)
        main_launches = dict(CP.launches)
        for name in REPLACES:
            check(main_launches.get(name, 0) > 0,
                  f"main path launched {name}")
    for layout, extra, st in main_stats:
        log(f"[5b] CLI 8192 x 48 {layout} {' '.join(extra)}: "
            f"{st['nblocks']} blocks in {st['elapsed_sec']:.3f} s, "
            f"{st['realtime_x']:.3f}x real time, "
            f"{st['kernel_launches']} kernel launches")
    log(f"[5b] launches over the full-size main path: {main_launches}")

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
    }
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
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
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
