"""Numerical parity sweeps on the card: every CUDA wrapper x layout x
streaming case against independent float64 numpy goldens.

The counterpart of the JAX package's on-chip sweeps,
``benchmarks/parity_tpu.py:run_sweep`` and
``benchmarks/parity_full.py:run_sweep``, with their cases, mode names,
bounds and report. ``chip_smoke.py`` holds each kernel against the port's
own plain PyTorch versions; this holds the kernels against the goldens
(``ops/golden.py``, ``ops/pfb_golden.py``: copies of the JAX package's
numpy models), which no code under test shares.

    python -m paf_baseband2power_tpu_torch.parity            # 75 cases
    python -m paf_baseband2power_tpu_torch.parity --full     # 15, 8192 x 48
    python -m paf_baseband2power_tpu_torch.parity --full --cases '^(power|stokes|scrunch)'
    python -m paf_baseband2power_tpu_torch.parity --platform cpu --ndf 2048 --nchk 1

``run_sweep`` (default ``--ndf 4096 --nchk 2``, blocks ``synthetic_block``
with rng 1001 and 1002): the 9 direct cases, ``pfb_power_cuda`` at nfft
128 one-shot and streaming, and the cross nfft 128-1024 x nout {1,
``--nout``} x Stokes x {wire, rows} x {one-shot, streaming} through
``pfb_spectra_cuda``, each streaming case continuing the one-shot's carry
(``return_history=True``). ``run_full`` (``--full``, 8192 x 48, rng 2001
and 2002, the production block): the JAX full sweep's 15 cases. Both
compute their goldens chunk by chunk (every detection is frequency-chunk
independent, so the chunks' outputs concatenated along the channel axis
are exact) in a pool of ``min(cores, nchk)`` processes, each golden when
its first case needs it; each row has the wrapper's time (``sec``, with
``--full`` ``kernel_sec``) and its golden's (``golden_sec``). One block
is on the card at a time. The pool's processes are spawned, and each
imports the caller's main module first: a script that calls
``run_sweep`` or ``run_full`` needs its ``if __name__ == "__main__":``
guard, or every golden process re-runs the script and dies.

Error: ``max|got - want| / max|want|`` (peak-normalized). Bounds: 1e-5
for the direct detections, 2e-5 for the PFB, the JAX sweep's.

``--platform cuda`` (the default) fails without a card (exit 2). Every
case runs its CUDA wrapper (``ops/cuda_power.py``, ``ops/cuda_pfb.py``);
a case whose wrapper's launch count (``cuda_power.launches``) did not
move fails, and nothing falls back to the plain version. ``--platform
cpu`` runs the same wrappers on CPU tensors, which take the plain
versions (the tests). A case that raises is recorded with its ``error``
and the sweep goes on. The report is rewritten after every case through
an atomic rename. The last line printed is ``{"ok", "cases", "failed"}``;
the exit code is 0 only if every case passed.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable

import numpy as np
import torch

from .ops import cuda_pfb as CF
from .ops import cuda_power as CP
from .ops import golden as G
from .ops import pfb as PF
from .ops import pfb_golden as PG
from .ops.frame import block_to_rows, synthetic_block
from .probes._common import add_platform, card, device_for

BOUND_DIRECT = 1e-5
BOUND_PFB = 2e-5
NTAP = 4
SWEEP_OUT = "parity_cuda.json"
FULL_OUT = "parity_full_cuda.json"


def _err(got: np.ndarray, want: np.ndarray) -> float:
    peak = float(np.abs(want).max())
    if peak == 0.0:
        return float(np.abs(got).max())
    return float(np.abs(got.astype(np.float64)
                        - want.astype(np.float64)).max() / peak)


def _stream(fn, *blocks: np.ndarray) -> np.ndarray:
    """``fn`` of ``blocks`` as one stream (concatenated along frames)."""
    return fn(blocks[0] if len(blocks) == 1
              else np.concatenate(blocks, axis=0))


def _chunk_golden(fn, *blocks: np.ndarray) -> np.ndarray:
    """Per-frequency-chunk float64 golden of ``blocks`` as one stream,
    concatenated on the channel (last) axis — exact for every
    chunk-independent detection."""
    return np.concatenate(
        [_stream(fn, *(b[:, c:c + 1] for b in blocks))
         for c in range(blocks[0].shape[1])], axis=-1)


def _chunk_of_files(fn, paths: list[str], c: int) -> np.ndarray:
    """``_chunk_golden`` of chunk ``c`` of the blocks saved at ``paths``
    (mapped, not read whole): one pool process's share."""
    return _chunk_golden(fn, *(np.load(p, mmap_mode="r")[:, c:c + 1]
                               for p in paths))


def _golden(pool, fn, names: tuple[str, ...], blocks: "Blocks") -> np.ndarray:
    """``_chunk_golden`` of the host blocks ``names``, one chunk per task
    in ``pool``; each process maps the blocks from files (sending a chunk
    through a pipe costs more than its golden)."""
    paths = [blocks.file(n) for n in names]
    futures = [pool.submit(_chunk_of_files, fn, paths, c)
               for c in range(blocks.nchk)]
    return np.concatenate([f.result() for f in futures], axis=-1)


@dataclasses.dataclass
class Case:
    """One mode: ``run(x)`` calls ``wrapper`` on the card block ``block``;
    ``pick`` takes its expected output out of the golden ``golden``."""
    mode: str
    bound: float
    wrapper: str
    block: str
    run: Callable[[torch.Tensor], torch.Tensor]
    golden: tuple           # (golden function, names of its host blocks)
    pick: Callable[[np.ndarray], np.ndarray] = lambda g: g
    meta: dict = dataclasses.field(default_factory=dict)


class Blocks:
    """The sweep's host blocks, made at first use, and the one block on
    the card. Names: ``b1``/``b2`` (canonical 6-D), ``wire1``/``wire2``,
    ``rows1``/``rows2``."""

    def __init__(self, ndf: int, nchk: int, seeds: tuple[int, int],
                 device: torch.device):
        self.ndf, self.nchk, self.device = ndf, nchk, device
        self._seeds = seeds
        self._host: dict[str, np.ndarray] = {}
        self._files: dict[str, str] = {}
        self._dir: str | None = None
        self._card: tuple[str, torch.Tensor] | None = None

    def host(self, name: str) -> np.ndarray:
        if name not in self._host:
            i = int(name[-1]) - 1
            if name.startswith("b"):
                print(f"generating block {name} ({self.ndf} x "
                      f"{self.nchk})...", flush=True)
                a = synthetic_block(rng=self._seeds[i], ndf=self.ndf,
                                    nchk=self.nchk)
            elif name.startswith("wire"):
                a = self.host(f"b{i + 1}").reshape(self.ndf, -1)
            else:
                a = block_to_rows(self.host(f"b{i + 1}"))
            self._host[name] = a
        return self._host[name]

    def file(self, name: str) -> str:
        """A ``.npy`` file of the host block ``name``, for other
        processes."""
        if name not in self._files:
            self._dir = self._dir or tempfile.mkdtemp(prefix="parity-")
            self._files[name] = os.path.join(self._dir, f"{name}.npy")
            np.save(self._files[name], self.host(name))
        return self._files[name]

    def close(self) -> None:
        """Remove the files; drop the block on the card."""
        self._card = None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir, self._files = None, {}

    def card(self, name: str) -> torch.Tensor:
        """``name`` on the device, dropping the block held before."""
        if self._card is None or self._card[0] != name:
            self._card = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self._card = (name, torch.from_numpy(self.host(name)).to(
                self.device))
        return self._card[1]


def _carry(held: dict, blocks: Blocks, first: str, nfft: int,
           layout: str) -> torch.Tensor:
    """The one-shot case's carry (``return_history=True``), or, when that
    case was not run, the same carry cut from the first block."""
    if "h" not in held:
        held["h"] = PF.pfb_history(torch.from_numpy(blocks.host(first)),
                                   nfft, NTAP, layout).to(blocks.device)
    return held["h"]


def _pfb_pair(tag: str, wrapper: str, layout: str, nfft: int,
              golden: tuple, blocks: Blocks, nout: int = 1,
              **kw) -> list[Case]:
    """The one-shot and streaming cases of one PFB configuration: block 1,
    then block 2 continuing its carry; the golden is of the two-block
    stream, spectra ``[:nout]`` and ``[nout:]``."""
    fn = getattr(CF, wrapper)
    if wrapper == "pfb_spectra_cuda":
        kw["nout"] = nout
    first, second = (f"{'rows' if layout == 'rows' else 'wire'}{i}"
                     for i in (1, 2))
    held: dict = {}

    def oneshot(x):
        out, held["h"] = fn(x, nfft, NTAP, layout=layout,
                            return_history=True, **kw)
        return out

    def streamed(x):
        return fn(x, nfft, NTAP, layout=layout,
                  history=_carry(held, blocks, first, nfft, layout), **kw)

    if wrapper == "pfb_power_cuda":
        picks = (lambda g: g[0], lambda g: g[1])
    else:
        picks = (lambda g: g[:nout], lambda g: g[nout:])
    return [Case(f"{tag} one-shot", BOUND_PFB, wrapper, first, oneshot,
                 golden, picks[0]),
            Case(f"{tag} streaming", BOUND_PFB, wrapper, second, streamed,
                 golden, picks[1])]


def _spectra_golden(nfft: int, nout: int = 2, stokes: bool = False):
    return functools.partial(PG.pfb_spectra_golden, nfft=nfft, ntap=NTAP,
                             nout=nout, stokes=stokes)


def _direct_goldens() -> tuple:
    """The golden specs of block 1 that several direct cases share:
    power, Stokes, and both x 64 windows."""
    b1 = ("b1",)
    return ((G.baseband2power_golden, b1), (G.baseband2stokes_golden, b1),
            (functools.partial(G.baseband2power_scrunch_golden, nout=64), b1),
            (functools.partial(G.baseband2stokes_scrunch_golden, nout=64),
             b1))


def sweep_cases(blocks: Blocks, nout_fine: int = 64) -> list[Case]:
    """``benchmarks/parity_tpu.py:run_sweep``'s 75 cases, in its order."""
    power, stokes, scrunch64, stokes64 = _direct_goldens()
    cases = [
        Case("power wire", BOUND_DIRECT, "baseband2power_cuda", "wire1",
             CP.baseband2power_cuda, power),
        Case("stokes wire", BOUND_DIRECT, "baseband2stokes_cuda", "wire1",
             CP.baseband2stokes_cuda, stokes),
        Case("scrunch[64] wire (dynamic-row path)", BOUND_DIRECT,
             "baseband2power_scrunch_cuda", "wire1",
             lambda x: CP.baseband2power_scrunch_cuda(x, 64),
             scrunch64),
        Case("scrunch[512] wire (small-window fused path)", BOUND_DIRECT,
             "baseband2power_scrunch_cuda", "wire1",
             lambda x: CP.baseband2power_scrunch_cuda(x, 512),
             (functools.partial(G.baseband2power_scrunch_golden, nout=512),
              ("b1",))),
        Case("stokes x scrunch[64] wire", BOUND_DIRECT,
             "baseband2stokes_scrunch_cuda", "wire1",
             lambda x: CP.baseband2stokes_scrunch_cuda(x, 64),
             stokes64),
        Case("stokes rows (nout=1)", BOUND_DIRECT,
             "baseband2stokes_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2stokes_scrunch_rows_cuda(x, 1)[0], stokes),
        Case("stokes x scrunch[64] rows", BOUND_DIRECT,
             "baseband2stokes_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2stokes_scrunch_rows_cuda(x, 64),
             stokes64),
        Case("power rows (nout=1)", BOUND_DIRECT,
             "baseband2power_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2power_scrunch_rows_cuda(x, 1)[0], power),
        Case("power x scrunch[64] rows", BOUND_DIRECT,
             "baseband2power_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2power_scrunch_rows_cuda(x, 64),
             scrunch64),
    ]
    both = ("b1", "b2")
    cases += _pfb_pair("pfb_power_fused 128 wire", "pfb_power_cuda", "wire",
                       128, (_spectra_golden(128), both), blocks)
    for nfft in PF.ROWS_NFFTS:
        for nout in (1, nout_fine):
            for stokes in (False, True):
                golden = (_spectra_golden(nfft, 2 * nout, stokes), both)
                for layout in ("wire", "rows"):
                    tag = (f"pfb {nfft}"
                           + (f" x waterfall[{nout}]" if nout > 1 else "")
                           + (" x stokes" if stokes else "")
                           + f" {layout}")
                    pair = _pfb_pair(tag, "pfb_spectra_cuda", layout, nfft,
                                     golden, blocks, nout=nout,
                                     stokes=stokes)
                    for case, streaming in zip(pair, (False, True)):
                        case.meta = dict(nfft=nfft, nout=nout, stokes=stokes,
                                         layout=layout, streaming=streaming)
                    cases += pair
    return cases


def full_cases(blocks: Blocks) -> list[Case]:
    """``benchmarks/parity_full.py:run_sweep``'s 15 cases, in its order."""
    power, stokes, scrunch64, stokes64 = _direct_goldens()
    cases = [
        Case("power wire", BOUND_DIRECT, "baseband2power_cuda", "wire1",
             CP.baseband2power_cuda, power),
        Case("stokes wire", BOUND_DIRECT, "baseband2stokes_cuda", "wire1",
             CP.baseband2stokes_cuda, stokes),
        Case("scrunch[64] wire (dynamic-row path)", BOUND_DIRECT,
             "baseband2power_scrunch_cuda", "wire1",
             lambda x: CP.baseband2power_scrunch_cuda(x, 64),
             scrunch64),
        Case("scrunch[256] wire (small-window fused path)", BOUND_DIRECT,
             "baseband2power_scrunch_cuda", "wire1",
             lambda x: CP.baseband2power_scrunch_cuda(x, 256),
             (functools.partial(G.baseband2power_scrunch_golden, nout=256),
              ("b1",))),
        Case("power rows (nout=1)", BOUND_DIRECT,
             "baseband2power_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2power_scrunch_rows_cuda(x, 1)[0], power),
        Case("stokes rows (nout=1)", BOUND_DIRECT,
             "baseband2stokes_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2stokes_scrunch_rows_cuda(x, 1)[0], stokes),
        Case("stokes x scrunch[64] rows (packed windows)", BOUND_DIRECT,
             "baseband2stokes_scrunch_rows_cuda", "rows1",
             lambda x: CP.baseband2stokes_scrunch_rows_cuda(x, 64),
             stokes64),
    ]
    both = ("b1", "b2")
    for nfft in (128, 1024):
        cases += _pfb_pair(f"pfb {nfft} rows", "pfb_spectra_cuda", "rows",
                           nfft, (_spectra_golden(nfft), both), blocks)
    cases += _pfb_pair("pfb 128 x stokes rows", "pfb_spectra_cuda", "rows",
                       128, (_spectra_golden(128, stokes=True), both), blocks,
                       stokes=True)
    cases += _pfb_pair("pfb_power_fused 128 wire", "pfb_power_cuda", "wire",
                       128, (_spectra_golden(128), both), blocks)
    return cases


def _report(what: str, blocks: Blocks) -> dict:
    return {
        "what": what,
        "metric": "max|got - want| / max|want| (peak-normalized)",
        "backend": blocks.device.type,
        "device": card(blocks.device),
        "ndf": blocks.ndf,
        "nchk": blocks.nchk,
        "date": time.strftime("%Y-%m-%d"),
        "cases": [],
        "ok": None,
    }


def _run(report: dict, cases: list[Case], blocks: Blocks, out_path: str,
         kernel_key: str) -> dict:
    """Run ``cases`` in order, recording each row in ``report`` (the
    wrapper's time under ``kernel_key``, its golden's under
    ``golden_sec``) and rewriting ``out_path`` after each. A golden is
    computed, chunk by chunk in a pool of ``min(cores, nchk)`` spawned
    processes, when the first case that needs it has run its wrapper,
    and kept until the last such case."""
    def save():
        report["ok"] = all(c.get("ok") for c in report["cases"])
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, out_path)

    on_card = blocks.device.type == "cuda"
    goldens: dict = {}    # golden spec -> its array, while cases need it
    left = collections.Counter(c.golden for c in cases)
    workers = min(len(os.sched_getaffinity(0)), blocks.nchk)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for c in cases:
            row = {"mode": c.mode, "bound": c.bound, "wrapper": c.wrapper,
                   **c.meta}
            try:
                x = blocks.card(c.block)
                n0 = CP.launches[c.wrapper]
                t0 = time.perf_counter()
                got = c.run(x).cpu().numpy()     # .cpu() waits for the card
                kernel_sec = time.perf_counter() - t0
                row["launches"] = CP.launches[c.wrapper] - n0
                if on_card and not row["launches"]:
                    raise RuntimeError(f"{c.wrapper} launched no kernel")
                t1 = time.perf_counter()
                if c.golden not in goldens:
                    goldens[c.golden] = _golden(pool, *c.golden, blocks)
                golden_sec = time.perf_counter() - t1
                want = c.pick(goldens[c.golden])
                if got.shape != want.shape:
                    raise ValueError(f"output {got.shape}, golden "
                                     f"{want.shape}")
                row["err"] = _err(got, want)
                row["ok"] = row["err"] <= c.bound
                row[kernel_key], row["golden_sec"] = kernel_sec, golden_sec
            except Exception as e:  # record, keep sweeping
                traceback.print_exc()
                row["error"] = f"{type(e).__name__}: {e}"
                row["ok"] = False
            left[c.golden] -= 1
            if not left[c.golden]:
                goldens.pop(c.golden, None)
            report["cases"].append(row)
            save()
            print(f"{'ok ' if row['ok'] else 'FAIL'} {c.mode}: "
                  f"{row.get('err', row.get('error'))}", flush=True)
    save()
    return report


def _select(cases: list[Case], pattern: str | None) -> list[Case]:
    if pattern is None:
        return cases
    chosen = [c for c in cases if re.search(pattern, c.mode)]
    if not chosen:
        raise ValueError(f"no case matches {pattern!r}")
    return chosen


def run_sweep(ndf: int = 4096, nchk: int = 2, out_path: str = SWEEP_OUT,
              nout_fine: int = 64, device: torch.device | str = "cuda",
              cases: str | None = None) -> dict:
    """Every wrapper x layout x streaming case at ``ndf x nchk`` against
    the float64 goldens (``benchmarks/parity_tpu.py:run_sweep``); writes
    and returns the report, with each case's ``sec`` (the wrapper) and
    ``golden_sec``. ``cases``: a regex of the modes to run."""
    blocks = Blocks(ndf, nchk, (1001, 1002), torch.device(device))
    try:
        return _run(_report(
            "On-card parity sweep: every CUDA wrapper x layout x streaming "
            "combination vs the float64 golden models (the counterpart of "
            "benchmarks/parity_tpu.py).", blocks),
            _select(sweep_cases(blocks, nout_fine), cases), blocks, out_path,
            "sec")
    finally:
        blocks.close()


def run_full(out_path: str = FULL_OUT, ndf: int = 8192, nchk: int = 48,
             device: torch.device | str = "cuda",
             cases: str | None = None) -> dict:
    """The flagship cases at the production block shape against goldens
    computed chunk by chunk (``benchmarks/parity_full.py:run_sweep``);
    writes and returns the report, with each case's ``kernel_sec`` and
    ``golden_sec``."""
    blocks = Blocks(ndf, nchk, (2001, 2002), torch.device(device))
    try:
        return _run(_report(
            "Full-geometry on-card parity: the flagship cases at the "
            "production block shape (8192 x 48, 2.8 GB) vs chunked float64 "
            "goldens (the counterpart of benchmarks/parity_full.py).",
            blocks), _select(full_cases(blocks), cases), blocks, out_path,
            "kernel_sec")
    finally:
        blocks.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paf_baseband2power_tpu_torch.parity",
        description="numerical parity of the CUDA wrappers against the "
        "float64 golden models; prints one JSON line last")
    add_platform(ap)
    ap.add_argument("--full", action="store_true",
                    help="the flagship cases at the production block shape "
                    "(parity_full) instead of the reduced-geometry sweep")
    ap.add_argument("--ndf", type=int, default=None,
                    help="frames per block (default 4096; 8192 with --full)")
    ap.add_argument("--nchk", type=int, default=None,
                    help="chunks per block (default 2; 48 with --full)")
    ap.add_argument("--nout", type=int, default=64,
                    help="waterfall nout for the fine-channel cross")
    ap.add_argument("--out", default=None,
                    help=f"report path (default ./{SWEEP_OUT}, with --full "
                    f"./{FULL_OUT})")
    ap.add_argument("--cases", default=None, metavar="REGEX",
                    help="run only the modes this regex finds")
    args = ap.parse_args(argv)
    device = device_for(ap, args.platform)
    try:
        if args.full:
            report = run_full(args.out or FULL_OUT, args.ndf or 8192,
                              args.nchk or 48, device, args.cases)
        else:
            report = run_sweep(args.ndf or 4096, args.nchk or 2,
                               args.out or SWEEP_OUT, args.nout, device,
                               args.cases)
    except ValueError as e:
        ap.error(str(e))
    bad = [c["mode"] for c in report["cases"] if not c["ok"]]
    print(json.dumps({"ok": report["ok"], "cases": len(report["cases"]),
                      "failed": bad}), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
