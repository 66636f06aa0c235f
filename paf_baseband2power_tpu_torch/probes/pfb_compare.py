"""Two builds of the PFB kernel on one card, in one process: the package's
``csrc/pfb.cu`` and another source of it with the same C interface (an
older commit's, unpacked with ``git show <commit>:<path>``).

    python -m paf_baseband2power_tpu_torch.probes.pfb_compare \\
        --other OLD/pfb.cu [--ndf 8192] [--nchk 48] [--iters 5]

It builds the other source beside the package's ``geometry.cuh`` and
``power.cu`` into ``.build/``, prints both builds' ptxas lines for the PFB
kernels, holds both against the plain version in float64 at
``--check-ndf`` frames (within 2e-5, peak-normalized) and checks that two
calls of the package's kernel are bit-equal, then times both on one
full-range block drawn on the card in turns (other, package, package,
other; CUDA events, after a warm-up) in the five cases of
``chip_smoke.py``'s phase 6, reading the SM clock and power while the
card runs. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import cuda_pfb as CF
from ..ops import pfb as PF
from ._common import PARITY_BOUND, peak_err

# (case, nfft, Stokes, spectra): chip_smoke.py's phase 6
CASES = [("nfft 128 power", 128, False, 1), ("nfft 1024 Stokes", 1024, True, 1),
         ("nfft 1024 power", 1024, False, 1), ("nfft 128 Stokes", 128, True, 1),
         ("nfft 128 power x 64 spectra", 128, False, 64)]
CHECKS = [(32, 4, 1, False), (64, 8, 2, True), (128, 4, 1, False),
          (128, 1, 4, True), (256, 8, 1, True), (512, 4, 2, False),
          (1024, 4, 1, True), (1024, 8, 2, False), (8, 3, 1, True)]


def build_other(source: str) -> str:
    """Build ``source`` as ``pfb.cu`` with the package's other files it
    needs; returns the library's path."""
    tmp = os.path.join(_build.BUILD_DIR, "other-src")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    shutil.copy(source, os.path.join(tmp, "pfb.cu"))
    for name in ("geometry.cuh", "power.cu"):
        shutil.copy(os.path.join(_build.CSRC_DIR, name), tmp)
    return _build.build(tmp, os.path.join(_build.BUILD_DIR, "other"))


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="another pfb.cu")
    ap.add_argument("--ndf", type=int, default=8192)
    ap.add_argument("--nchk", type=int, default=48)
    ap.add_argument("--check-ndf", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = {"other": _build.bind_library(build_other(args.other)),
            "package": _build.load_library()}
    for name, lib in libs.items():
        for line in _build.ptxas_report(lib._name).splitlines():
            if "pfb" in line or "Used" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    def run(which, x, nfft, ntap, nout, stokes, carry=None, mean=False):
        return CF._launch(x, "wire", nfft, ntap, "hamming", nout, stokes,
                          mean, True, carry, lib=libs[which])

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.check_ndf)
    x, prev = (torch.randint(-32768, 32768, (args.check_ndf, args.nchk * 3584),
                             dtype=torch.int16, device=dev, generator=gen)
               for _ in range(2))
    errors = {}
    for nfft, ntap, nout, stokes in CHECKS:
        carry = PF.pfb_history(prev, nfft, ntap)
        want = PF.pfb_spectra(x, nfft, ntap, nout=nout, stokes=True,
                              history=carry, dtype=torch.float64)
        want = want if stokes else want[:, :1]
        for which in libs:
            e = peak_err(run(which, x, nfft, ntap, nout, stokes, carry), want)
            errors[f"{which} nfft {nfft} ntap {ntap} nout {nout} "
                   f"stokes {stokes}"] = e[1]
            if e[1] >= PARITY_BOUND:
                raise SystemExit(f"{which} nfft {nfft} ntap {ntap}: "
                                 f"{e[1]:.3e} against float64")
        a = run("package", x, nfft, ntap, nout, stokes, carry, mean=True)
        b = run("package", x, nfft, ntap, nout, stokes, carry, mean=True)
        if not torch.equal(a, b):
            raise SystemExit(f"nfft {nfft}: two calls differ")
    print(f"[check] {args.check_ndf} x {args.nchk}: both builds within "
          f"{PARITY_BOUND} of float64 (worst {max(errors.values()):.3e}); "
          "two calls of the package's bit-equal", flush=True)
    del x, prev

    big = torch.randint(-32768, 32768, (args.ndf, args.nchk * 3584),
                        dtype=torch.int16, device=dev, generator=gen)

    def ms(fn, n):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    times, load = {}, {}
    for case, nfft, stokes, nout in CASES:
        fns = {w: (lambda w=w: run(w, big, nfft, 4, nout, stokes))
               for w in libs}
        o1, p1, p2, o2 = (ms(fns[w], args.iters)
                          for w in ("other", "package", "package", "other"))
        times[case] = {"package": (p1 + p2) / 2, "other": (o1 + o2) / 2}
        for w in libs:     # the clock while 20 launches run
            for _ in range(20):
                fns[w]()
            load[f"{case} {w}"] = smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
        print(f"[time] {case}: package {times[case]['package']:.4f} ms, "
              f"other {times[case]['other']:.4f} ms per {args.ndf} x "
              f"{args.nchk} block ({smi('name,power.limit')})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi("name,power.limit"), "ndf": args.ndf,
                      "nchk": args.nchk, "ms": times, "under_load": load,
                      "errors": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
