"""Streaming executor of the port: source -> pinned staging -> H2D ->
detection kernel -> D2H -> sink, on one explicit ``torch.device``.

Counterpart of ``paf_baseband2power_tpu/runtime/pipeline.py`` for direct
detection (power or full Stokes, wire or series rows, ``nout`` >= 1,
``mean``) and the PFB spectrometer (``pfb_nfft``, with the same options),
whose overlap-save carry stays on the device from one block to the next:

    host source  ->  copy into a pinned slot  ->  H2D on a copy stream
                 ->  detection kernel on the current stream  ->  D2H (async)
                 ->  bounded in-flight queue  ->  sink

``depth`` bounds the blocks in flight, the role of the ring's NBLK: there
are ``depth`` pinned host slots and ``depth`` device slots. A pinned slot
is refilled only after the event of its last H2D copy has completed, and a
device slot is overwritten only after the event of the kernel that read it,
so no block is overwritten while still in flight. The PFB carry is a tensor
of its own (``ops/pfb.py:pfb_history``), never a view of a slot, so the
next block's kernel reads it whatever ``depth`` is. On the CPU the same
loop runs the plain PyTorch version with no copies.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import constants as C
from ..io.dada import DadaFileReader, DadaFileWriter, DadaHeader, output_header
from ..ops import cuda_pfb as CPF
from ..ops import cuda_power as CP
from ..ops import pfb as PF
from ..ops.frame import synthetic_block
from . import debug
from .log import open_log


@dataclasses.dataclass
class PipelineStats:
    nblocks: int = 0
    nbytes_in: int = 0
    nbytes_out: int = 0
    ndf: int = 0                     # frames per block (from the stream)
    elapsed: float = 0.0
    kernel_launches: int = 0         # kernel launches during the run
    block_seconds: list = dataclasses.field(default_factory=list)

    @property
    def samples_per_sec(self) -> float:
        if not self.elapsed:
            return 0.0
        nsamp = self.nbytes_in // (C.NPOL_SAMP * C.NDIM_POL * C.NBYTE_IN)
        # complex samples, both pols
        return nsamp * C.NPOL_SAMP / self.elapsed

    @property
    def realtime_fraction(self) -> float:
        """How many real-time streams this run sustained (>=1 is real
        time), from the stream's own frames per block."""
        if not self.elapsed or not self.ndf:
            return 0.0
        return self.nblocks * self.ndf * C.TDF_SEC / self.elapsed


class SyntheticSource:
    """In-memory block generator (the software BMF, for tests)."""

    def __init__(self, nblocks: int, ndf: int = C.NDF_BLK,
                 nchk: int = C.NCHK_NIC, seed: int = 0, scale: float = 64.0):
        self.header = None
        self._blocks = nblocks
        self._ndf, self._nchk = ndf, nchk
        self._seed, self._scale = seed, scale

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self._blocks):
            b = synthetic_block(rng=self._seed + i, ndf=self._ndf,
                                nchk=self._nchk, scale=self._scale)
            yield b.reshape(self._ndf, -1)


class FileSource:
    """Replay a recorded DADA baseband file, whole blocks after the header.

    Recordings made from a device-layout ring (header ``ORDER SERIES``)
    are detected and viewed as series-row blocks; ``layout`` overrides.
    Blocks are read-only views of the file's bytes.
    """

    def __init__(self, path: str, ndf: int = C.NDF_BLK,
                 nchk: int = C.NCHK_NIC, layout: str | None = None):
        self._reader = DadaFileReader(path)
        self.header = self._reader.header
        self._ndf, self._nchk = ndf, nchk
        if layout is None:
            layout = ("rows" if (self.header or {}).get("ORDER") == "SERIES"
                      else "wire")
        if layout not in ("wire", "rows"):
            raise ValueError(f"unknown layout '{layout}'")
        self.layout = layout
        self.block_nbytes = ndf * nchk * C.DT_SIZE

    def __iter__(self) -> Iterator[np.ndarray]:
        for raw in self._reader.blocks(self.block_nbytes):
            x = np.frombuffer(raw, dtype="<i2")
            if self.layout == "rows":
                yield x.reshape(self._nchk * C.NCHAN_CHK * C.NPOL_SAMP, -1)
            else:
                yield x.reshape(self._ndf, -1)
        self._reader.close()


class FileSink:
    """Spill power records to a .dada file (the ``dada_dbdisk`` analogue)."""

    def __init__(self, path: str, header: DadaHeader | None = None):
        self._writer = DadaFileWriter(path, header or output_header())

    def write(self, power: np.ndarray) -> None:
        self._writer.write(np.ascontiguousarray(power, dtype="<f4"))

    def close(self) -> None:
        self._writer.close()


class MemorySink:
    """Collect power records in memory (tests)."""

    def __init__(self):
        self.records: list[np.ndarray] = []

    def write(self, power: np.ndarray) -> None:
        self.records.append(np.asarray(power).copy())

    def close(self) -> None:
        pass


class _Staging:
    """``depth`` host slots (pinned for a CUDA device) and device slots,
    with the events that say when each may be reused."""

    def __init__(self, shape: tuple, device: torch.device, depth: int):
        self.shape = tuple(shape)
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(self.shape, dtype=torch.int16,
                                 pin_memory=self.cuda) for _ in range(depth)]
        self.dev = ([torch.empty(self.shape, dtype=torch.int16, device=device)
                     for _ in range(depth)] if self.cuda else self.host)
        self.copied: list = [None] * depth   # H2D of the slot finished
        self.read: list = [None] * depth     # kernel reading the slot finished
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._next = 0

    def put(self, block: np.ndarray) -> tuple[torch.Tensor, int]:
        """Stage one host block; returns its device tensor (ready for work
        on the current stream) and its slot."""
        if block.shape != self.shape:
            raise ValueError(f"block shape {block.shape} changed from "
                             f"{self.shape} mid-stream")
        k = self._next
        self._next = (k + 1) % len(self.host)
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        np.copyto(self.host[k].numpy(), block)
        if not self.cuda:
            return self.host[k], k
        with torch.cuda.stream(self.stream):
            if self.read[k] is not None:
                self.stream.wait_event(self.read[k])
            self.dev[k].copy_(self.host[k], non_blocking=True)
            self.copied[k] = torch.cuda.Event()
            self.copied[k].record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self.copied[k])
        return self.dev[k], k

    def fetch(self, out: torch.Tensor, k: int):
        """Queue the D2H copy of slot ``k``'s output; returns the host
        tensor and the event that marks it (and the slot's read) done."""
        if not self.cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.read[k] = done
        return host, done


class PowerPipeline:
    """Run source -> detection step on ``device`` -> sink with bounded
    overlap.

    On a CUDA device every block goes through the CUDA kernels of
    ``ops/cuda_power.py`` and ``ops/cuda_pfb.py``; on the CPU through their
    plain versions. ``stokes`` records I, Q, U, V per channel instead of
    total power. ``pfb_nfft`` channelizes each coarse channel into that
    many fine channels first (``pfb_ntap`` taps, ``pfb_window``): through
    the CUDA kernel where ``cuda_pfb.kernel_takes`` the shape, else through
    ``torch.fft`` (``cuda_pfb.pfb_*_torch``), chosen once, here.
    """

    def __init__(self, device: torch.device | str, mean: bool = False,
                 depth: int = 2, name: str = "baseband2power",
                 log_dir: str | None = None, nout: int = 1,
                 device_layout: bool = False, stokes: bool = False,
                 pfb_nfft: int = 0, pfb_ntap: int = 4,
                 pfb_window: str = "hamming"):
        if nout < 1:
            raise ValueError(f"nout={nout} must be >= 1")
        self.device = torch.device(device)
        self._mean, self._nout = mean, nout
        self._device_layout = device_layout
        self._stokes = stokes
        self._depth = max(1, depth)
        self._pfb = None
        self._pfb_route = ""
        if pfb_nfft:
            if device_layout:
                PF.check_rows_nfft(pfb_nfft)
                PF.check_rows_ntap(pfb_ntap)
            kw = dict(window=pfb_window, mean=mean,
                      layout="rows" if device_layout else "wire")
            # by shape alone, as the JAX factories choose the fused kernel
            why = CPF.kernel_refuses(pfb_nfft, pfb_ntap)
            self._pfb_route = ("CUDA kernel" if why is None
                               else f"torch.fft: {why}")
            if nout == 1 and not stokes:
                self._pfb = PF.make_streaming_pfb(
                    pfb_nfft, pfb_ntap, power=CPF.pfb_power_cuda
                    if why is None else CPF.pfb_power_torch, **kw)
            else:
                self._pfb = PF.make_streaming_spectra(
                    pfb_nfft, pfb_ntap, nout=nout, stokes=stokes,
                    spectra=CPF.pfb_spectra_cuda
                    if why is None else CPF.pfb_spectra_torch, **kw)
        self._carry = None
        self.log = open_log(name, log_dir)
        if self._pfb is not None:
            self.log.info("PFB route: %s", self._pfb_route)

    def power(self, x: torch.Tensor) -> torch.Tensor:
        """One block's record: ``(nchan,)`` or ``(nout, nchan)`` float32,
        with Stokes ``(4, nchan)`` or ``(nout, 4, nchan)``. With the PFB,
        ``nchan`` counts fine channels, Stokes keeps its ``nout`` axis
        (``(1, 4, nchan)`` at ``nout = 1``, as in the JAX package), and
        each call continues the stream from the previous block's carry."""
        nout, mean, stokes = self._nout, self._mean, self._stokes
        if self._pfb is not None:
            out, self._carry = self._pfb(x, self._carry)
            return out
        if self._device_layout:
            fn = (CP.baseband2stokes_scrunch_rows_cuda if stokes
                  else CP.baseband2power_scrunch_rows_cuda)
            out = fn(x, nout, mean=mean)
            return out[0] if nout == 1 else out
        if nout == 1:
            fn = CP.baseband2stokes_cuda if stokes else CP.baseband2power_cuda
            return fn(x, mean=mean)
        fn = (CP.baseband2stokes_scrunch_cuda if stokes
              else CP.baseband2power_scrunch_cuda)
        return fn(x, nout, mean=mean)

    def warmup(self, ndf: int, nchk: int = C.NCHK_NIC) -> float:
        """Build and load the kernels and launch them once on zeros made on
        the device; returns seconds. A live ring source needs this before
        data flows, or the first block's build stalls the ring."""
        t0 = time.perf_counter()
        if self._device_layout:
            shape = (nchk * C.NCHAN_CHK * C.NPOL_SAMP, ndf, 2 * C.NSAMP_DF)
        else:
            shape = (ndf, nchk * C.DT_SIZE // 2)
        zeros = torch.zeros(shape, dtype=torch.int16, device=self.device)
        self.power(zeros)
        if self._pfb is not None:
            # the step with a carry as well; the stream starts without one
            self.power(zeros)
            self._carry = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.log.info("warmup: built and ran the %s step for (%d, %d) "
                      "on %s in %.2f s",
                      self._mode(), ndf, nchk,
                      self.device, dt)
        return dt

    def _mode(self) -> str:
        mode = "Stokes" if self._stokes else "power"
        if self._pfb is None:
            return mode
        return f"PFB {mode} ({self._pfb_route})"

    def run(self, source: Iterable[np.ndarray], sink) -> PipelineStats:
        """Stream every block of ``source`` to ``sink``; a PFB stream starts
        without a carry."""
        stats = PipelineStats()
        self._carry = None
        staging: _Staging | None = None
        inflight: collections.deque = collections.deque()  # (host, event)
        launches0 = sum(CP.launches.values())
        t_start = t_block = time.perf_counter()
        self.log.info("pipeline start: device=%s depth=%d nout=%d layout=%s "
                      "mode=%s", self.device, self._depth, self._nout,
                      "rows" if self._device_layout else "wire", self._mode())

        def drain_one():
            nonlocal t_block
            host, ready = inflight.popleft()
            if ready is not None:
                ready.synchronize()
            row = host.numpy()
            if debug.debug_enabled():
                # Q, U and V are legitimately negative
                debug.check_power(row, stats.nblocks, signed=self._stokes)
                self.log.info("block %d ok: sum=%.6g max=%.6g",
                              stats.nblocks, row.sum(), row.max())
            sink.write(row)
            now = time.perf_counter()
            stats.block_seconds.append(now - t_block)
            stats.nbytes_out += row.size * 4
            stats.nblocks += 1
            t_block = now

        try:
            for block in source:
                if self._device_layout and block.ndim == 2:
                    # rows blocks go H2D 3-D (nseries, ndf, 256)
                    block = block.reshape(block.shape[0], -1, 2 * C.NSAMP_DF)
                if not stats.ndf:
                    stats.ndf = (block.shape[1] if self._device_layout
                                 else block.shape[0])
                if staging is None:
                    staging = _Staging(block.shape, self.device, self._depth)
                x, slot = staging.put(block)
                inflight.append(staging.fetch(self.power(x), slot))
                stats.nbytes_in += block.nbytes
                while len(inflight) > self._depth:
                    drain_one()
            while inflight:
                drain_one()
            stats.elapsed = time.perf_counter() - t_start
        finally:
            sink.close()
        stats.kernel_launches = sum(CP.launches.values()) - launches0
        self.log.info(
            "pipeline done: %d blocks, %.3f s, %.3g samp/s, %.2fx real time, "
            "%d kernel launches", stats.nblocks, stats.elapsed,
            stats.samples_per_sec, stats.realtime_fraction,
            stats.kernel_launches)
        return stats
