"""Two builds of the probe kernels K12 and K13 on one card, in one process:
the package's ``csrc/probe_planes.cu`` and ``csrc/probe_karatsuba.cu`` and
another source of each with the same C interface (an older commit's,
unpacked with ``git show <commit>:<path>``).

    python -m paf_baseband2power_tpu_torch.probes.probe_compare \\
        --other-dir OLD [--ndf 8192] [--nchk 48] [--iters 3]

``OLD`` holds the other ``probe_planes.cu`` and ``probe_karatsuba.cu``;
they are built together (with any ``*.cuh`` of ``OLD``, and the package's
``power.cu`` for its error strings) into ``.build/``.
It prints both builds' ptxas lines and tensor-core instruction counts for
the probe kernels, holds both against the plain versions in float64 at 28
series x 128 frames (every nfft and ``stage_a`` of the planes kernel, ntap
4 and 8; the Karatsuba kernel at R 128, 32, 16: within 2e-5,
peak-normalized), checks that two calls of each package kernel are
bit-equal, then times both builds on one block of int16 in [-256, 256)
drawn on the card, in turns (other, package, package, other; CUDA events,
after a warm-up): the Karatsuba kernel at R 1024 and 2048, the planes
kernel at nfft 1024 for every ``stage_a``, and beside them the production
spectrometer at nfft 1024 (``pfb_spectra_cuda(rows, 1024, 4,
layout="rows")``), reading the SM clock and power while the card runs.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

import torch

from ..ops import _build
from ..ops import cuda_pfb as CF
from ._common import PARITY_BOUND, peak_err
from .pfb_compare import smi
from . import karatsuba as K
from . import wide_reshape as W

SOURCES = ("probe_planes.cu", "probe_karatsuba.cu")
KERNELS = ("planes_kernel", "karatsuba_kernel")


def build_other(other_dir: str) -> str:
    """Build the other probe sources; returns the library's path."""
    tmp = os.path.join(_build.BUILD_DIR, "other-probes-src")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for path in ([os.path.join(_build.CSRC_DIR, n)    # the error strings
                  for n in ("geometry.cuh", "power.cu")]
                 + [os.path.join(other_dir, n) for n in SOURCES]
                 + glob.glob(os.path.join(other_dir, "*.cuh"))):
        shutil.copy(path, tmp)
    return _build.build(tmp, os.path.join(_build.BUILD_DIR, "other-probes"))


def report(name: str, path: str) -> None:
    """Print the ptxas lines and tensor-core counts of the probe kernels."""
    source = ""
    for line in _build.ptxas_report(path).splitlines():
        source = line[3:] if line.startswith("== ") else source
        if source in SOURCES and ("Compiling entry" in line or "Used" in line
                                  or "spill" in line):
            print(f"[ptxas {name}] {line.strip()}", flush=True)
    for kernel, n in _build.sass_counts(path).items():
        if any(k in kernel for k in KERNELS):
            print(f"[sass {name}] {kernel}: {n}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-dir", required=True,
                    help="a directory with another probe_planes.cu and "
                    "probe_karatsuba.cu")
    ap.add_argument("--ndf", type=int, default=8192)
    ap.add_argument("--nchk", type=int, default=48)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    paths = {"other": build_other(args.other_dir), "package": _build.build()}
    libs = {"other": _build.bind_library(paths["other"]),
            "package": _build.load_library()}
    for name, path in paths.items():
        report(name, path)

    gen = torch.Generator(device=dev)
    gen.manual_seed(128)
    rows = torch.randint(-256, 256, (28, 128, 256), dtype=torch.int16,
                         device=dev, generator=gen)
    cases = []        # (label, kernel call taking lib=, float64 reference)
    for nfft in (128, 256, 512, 1024):
        xp = W.to_planes(rows, nfft // 128)
        for ntap in (4, 8):
            for sa in W.STAGE_A:
                if sa != "fft8" or nfft == 1024:
                    cases.append((
                        f"planes nfft {nfft} ntap {ntap} {sa}",
                        lambda lib, xp=xp, nfft=nfft, ntap=ntap, sa=sa:
                        W.planes_cuda(xp, nfft, ntap, 8, sa, lib=lib),
                        W.planes(xp, nfft, ntap, 8, sa,
                                 dtype=torch.float64)))
    for R in (128, 32, 16):
        cases.append((f"karatsuba R {R}",
                      lambda lib, R=R: K.karatsuba_planar_cuda(rows, R, lib),
                      K.karatsuba_planar(rows, R, dtype=torch.float64)))
    errors = {}
    for label, call, want in cases:
        for which, lib in libs.items():
            e = peak_err(call(lib), want)[1]
            errors[f"{which} {label}"] = e
            if e >= PARITY_BOUND:
                raise SystemExit(f"{which} {label}: {e:.3e} against float64")
        if not torch.equal(call(libs["package"]), call(libs["package"])):
            raise SystemExit(f"{label}: two calls differ")
    print(f"[check] 28 x 128: both builds within {PARITY_BOUND} of float64 "
          f"(worst {max(errors.values()):.3e}); two calls of the package's "
          "bit-equal", flush=True)
    del rows

    big = torch.randint(-256, 256, (args.nchk * 14, args.ndf, 256),
                        dtype=torch.int16, device=dev, generator=gen)
    xp = W.to_planes(big, 8)

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

    timed = [(f"karatsuba R {R}",
              lambda lib, R=R: K.karatsuba_planar_cuda(big, R, lib))
             for R in (1024, 2048)]
    timed += [(f"planes nfft 1024 R 128 {sa}",
               lambda lib, sa=sa: W.planes_cuda(xp, 1024, 4, 128, sa, lib=lib))
              for sa in W.STAGE_A]
    times, load = {}, {}
    for case, call in timed:
        fns = {w: (lambda w=w: call(libs[w])) for w in libs}
        o1, p1, p2, o2 = (ms(fns[w], args.iters)
                          for w in ("other", "package", "package", "other"))
        times[case] = {"package": (p1 + p2) / 2, "other": (o1 + o2) / 2}
        for w in libs:     # the clock while 10 launches run
            for _ in range(10):
                fns[w]()
            load[f"{case} {w}"] = smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
        print(f"[time] {case}: package {times[case]['package']:.4f} ms, "
              f"other {times[case]['other']:.4f} ms per {args.ndf} x "
              f"{args.nchk} block ({smi('name,power.limit')})", flush=True)
    prod = ms(lambda: CF.pfb_spectra_cuda(big, 1024, 4, layout="rows"),
              args.iters)
    times["production rows nfft 1024"] = {"package": prod}
    print(f"[time] production rows nfft 1024 (pfb_spectra_cuda): {prod:.4f} "
          "ms per block", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi("name,power.limit"), "ndf": args.ndf,
                      "nchk": args.nchk, "ms": times, "under_load": load,
                      "errors": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
