"""Two builds of the PFB kernel on one card, in one process: the package's
``csrc/pfb.cu`` and another source of it with the same C interface (an
older commit's, unpacked with ``git show <commit>:<path>``).

    python -m paf_baseband2power_tpu_torch.probes.pfb_compare \\
        --other OLD/pfb.cu [--ndf 8192] [--nchk 48] [--iters 5]

It builds the other source beside the package's ``geometry.cuh`` and
``power.cu`` into ``.build/``, prints both builds' ptxas lines for the PFB
kernels and the ``SHFL`` instructions in each PFB kernel's SASS, holds
both against the plain version in float64 at ``--check-ndf`` frames
(within 2e-5, peak-normalized; nfft 128-1024, power and Stokes, wire and
rows, ntap 4 and 8, with a carry, and a few other shapes) and checks that
two calls of the package's kernel are bit-equal, then times both on one
full-range block drawn on the card in turns (other, package, package,
other; CUDA events, after a warm-up) in the five cases of
``chip_smoke.py``'s phase 6 and at nfft 256 and 512, reading the SM clock
and power while the card runs. In every check and case it reports
whether the two builds' records are bit-equal, and where they are not,
how many elements differ and their largest difference over the float64
record's peak; in every case the FFT lane stages each build reports
(``cuda_pfb.fft_lane_stages``). The last line is one JSON object.
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

# (case, nfft, Stokes, spectra, ntap): chip_smoke.py's phase 6, then the
# wide kernel's other sizes
CASES = ([("nfft 128 power", 128, False, 1, 4),
          ("nfft 1024 Stokes", 1024, True, 1, 4),
          ("nfft 1024 power", 1024, False, 1, 4),
          ("nfft 128 Stokes", 128, True, 1, 4),
          ("nfft 128 power x 64 spectra", 128, False, 64, 4)]
         + [(f"nfft {n} {'Stokes' if st else 'power'} ntap {t}", n, st, 1, t)
            for n in (256, 512) for st in (False, True) for t in (4, 8)])
# (nfft, ntap, nout, Stokes, layout), each with a carry
CHECKS = ([(32, 4, 1, False, "wire"), (64, 8, 2, True, "wire"),
           (128, 1, 4, True, "wire"), (512, 4, 2, False, "wire"),
           (1024, 8, 2, False, "wire"), (8, 3, 1, True, "wire")]
          + [(n, t, 1, st, lay) for n in (128, 256, 512, 1024) for t in (4, 8)
             for st in (False, True) for lay in ("wire", "rows")])


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
        for kernel, n in _build.sass_counts(lib._name, ("SHFL",)).items():
            if "pfb_kernel" in kernel:
                print(f"[sass {name}] {kernel}: {n['SHFL']} SHFL", flush=True)

    def run(which, x, nfft, ntap, nout, stokes, carry=None, mean=False,
            layout="wire"):
        return CF._launch(x, layout, nfft, ntap, "hamming", nout, stokes,
                          mean, True, carry, lib=libs[which])[0]

    def rows(x):
        return x.view(args.nchk * 14, x.shape[0], 256)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.check_ndf)
    x, prev = (torch.randint(-32768, 32768, (args.check_ndf, args.nchk * 3584),
                             dtype=torch.int16, device=dev, generator=gen)
               for _ in range(2))
    errors, bit_equal, differ = {}, {}, {}
    for nfft, ntap, nout, stokes, layout in CHECKS:
        xl, pl = (x, prev) if layout == "wire" else (rows(x), rows(prev))
        carry = PF.pfb_history(pl, nfft, ntap, layout)
        want = PF.pfb_spectra(xl, nfft, ntap, nout=nout, stokes=True,
                              history=carry, layout=layout,
                              dtype=torch.float64)
        want = want if stokes else want[:, :1]
        check = (f"nfft {nfft} ntap {ntap} nout {nout} stokes {stokes} "
                 f"{layout}")
        got = {}
        for which in libs:
            got[which] = run(which, xl, nfft, ntap, nout, stokes, carry,
                             layout=layout)
            e = peak_err(got[which], want)
            errors[f"{which} {check}"] = e[1]
            if e[1] >= PARITY_BOUND:
                raise SystemExit(f"{which} {check}: {e[1]:.3e} against "
                                 "float64")
        bit_equal[check] = torch.equal(got["package"], got["other"])
        if not bit_equal[check]:
            d = (got["package"].double() - got["other"].double()).abs()
            differ[check] = {"elements": int((d != 0).sum()),
                             "of": d.numel(),
                             "max_over_peak": (d.max() / want.abs().max()
                                               ).item()}
            print(f"[differ] {check}: {differ[check]}", flush=True)
        a = run("package", xl, nfft, ntap, nout, stokes, carry, mean=True,
                layout=layout)
        b = run("package", xl, nfft, ntap, nout, stokes, carry, mean=True,
                layout=layout)
        if not torch.equal(a, b):
            raise SystemExit(f"{check}: two calls differ")
    print(f"[check] {args.check_ndf} x {args.nchk}: both builds within "
          f"{PARITY_BOUND} of float64 (worst {max(errors.values()):.3e}); "
          "two calls of the package's bit-equal; the builds' records "
          f"bit-equal in {sum(bit_equal.values())} of {len(bit_equal)}",
          flush=True)
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

    times, load, lanes = {}, {}, {}
    for case, nfft, stokes, nout, ntap in CASES:
        fns = {w: (lambda w=w: run(w, big, nfft, ntap, nout, stokes))
               for w in libs}
        rec = {}
        for w in libs:
            before = CF.fft_lane_stages.copy()
            rec[w] = fns[w]()
            lanes[f"{case} {w}"] = (dict(CF.fft_lane_stages - before)
                                    or "not reported")
        bit_equal[case] = torch.equal(rec["package"], rec["other"])
        del rec
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
              f"{args.nchk} block ({smi('name,power.limit')}); records "
              f"{'' if bit_equal[case] else 'not '}bit-equal; FFT lane "
              f"stages: package {lanes[f'{case} package']}, other "
              f"{lanes[f'{case} other']}", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi("name,power.limit"), "ndf": args.ndf,
                      "nchk": args.nchk, "ms": times, "under_load": load,
                      "errors": errors, "bit_equal": bit_equal,
                      "differ": differ, "lane_stages": lanes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
