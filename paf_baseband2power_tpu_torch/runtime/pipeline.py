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
so no block is overwritten while still in flight. On a CUDA device a block
whose host memory recurs (a pool of host blocks that the caller hands in
again: ``host_register.py``) goes H2D straight from that memory, once
registered, instead of through a pinned slot; the source is then asked for
its next block only after that H2D has finished, so a source may reuse its
memory then, as after a copy. The PFB carry is a tensor of its own
(``ops/pfb.py:pfb_history``), never a view of a slot, so the next block's
kernel reads it whatever ``depth`` is. On the CPU the same loop runs the
plain PyTorch version with no copies.

While a torch profiler records, each block's steps are spans
(``runtime/trace.py``), flat and in the loop's order: ``pafb2p.source``,
``stage.wait`` (only when the slot's H2D has not finished), ``stage.copy``
(not for a block read in place; ``stage.register`` where it is registered),
``stage.h2d``, ``step``, ``fetch``, ``drain.wait`` (only when the record
has not arrived), ``sink``, and ``stage.wait`` again before the next
``source`` while an H2D from the source's memory has not finished.
``PipelineStats.slot_waits`` and ``record_waits`` count the waits, and
``direct_h2d`` the blocks read in place, whether or not a profiler records.
Both waits in ``slot_waits`` are a beam held by its own H2D. Where blocks
go in place and the link is the slower step, the wait before ``source``
comes about once a block, so ``slot_waits`` then nears ``direct_h2d``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .. import constants as C
from ..io.dada import DadaFileReader, DadaFileWriter, DadaHeader, output_header
from ..ops import cuda_pfb as CPF
from ..ops import cuda_power as CP
from ..ops.frame import synthetic_block
from . import debug
from .host_register import HOST_REGISTRY
from .log import open_log
from .trace import span


@dataclasses.dataclass
class PipelineStats:
    nblocks: int = 0
    nbytes_in: int = 0
    ndf: int = 0                     # frames per block (from the stream)
    elapsed: float = 0.0
    kernel_launches: int = 0         # kernel launches during the run
    partial_bytes: int = 0           # float64 PFB partials written (bytes)
    # PFB kernel launches by the stages of its sample ring (1: none ahead)
    pfb_stage_depths: dict = dataclasses.field(default_factory=dict)
    # PFB kernel launches by the cross-lane shuffle stages of their FFTs
    pfb_fft_lane_stages: dict = dataclasses.field(default_factory=dict)
    slot_waits: int = 0              # an H2D from a slot or the source not done
    record_waits: int = 0            # a block's record not yet on the host
    direct_h2d: int = 0              # blocks H2D straight from the source
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
    with the events that say when each may be reused; each wait for a
    slot's H2D counts in ``stats.slot_waits``. On a CUDA device a block
    that ``HOST_REGISTRY`` holds page-locked skips the host slot."""

    def __init__(self, shape: tuple, device: torch.device, depth: int,
                 stats: PipelineStats):
        self.shape = tuple(shape)
        self.stats = stats
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(self.shape, dtype=torch.int16,
                                 pin_memory=self.cuda) for _ in range(depth)]
        self.dev = ([torch.empty(self.shape, dtype=torch.int16, device=device)
                     for _ in range(depth)] if self.cuda else self.host)
        self.copied: list = [None] * depth   # H2D of the slot finished
        self.read: list = [None] * depth     # kernel reading the slot finished
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.direct = None    # H2D of the last block read in place finished
        self._next = 0

    def put(self, block: np.ndarray) -> tuple[torch.Tensor, int]:
        """Stage one host block; returns its device tensor (ready for work
        on the current stream) and its slot."""
        if block.shape != self.shape:
            raise ValueError(f"block shape {block.shape} changed from "
                             f"{self.shape} mid-stream")
        k = self._next
        self._next = (k + 1) % len(self.host)
        src = HOST_REGISTRY.take(block) if self.cuda else None
        if src is None:
            copied = self.copied[k]
            if copied is not None and not copied.query():
                self.stats.slot_waits += 1
                with span("stage.wait"):
                    copied.synchronize()
            with span("stage.copy"):
                np.copyto(self.host[k].numpy(), block)
        with span("stage.h2d"):
            if not self.cuda:
                return self.host[k], k
            with torch.cuda.stream(self.stream):
                if self.read[k] is not None:
                    self.stream.wait_event(self.read[k])
                self.dev[k].copy_(self.host[k] if src is None else src,
                                  non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            torch.cuda.current_stream(self.device).wait_event(done)
        if src is None:
            self.copied[k] = done
        else:
            self.direct = done
            self.stats.direct_h2d += 1
        return self.dev[k], k

    def wait_direct(self) -> None:
        """Wait for the H2D of the last block read in place, if it has not
        finished, so that the source may reuse that memory; a slot wait."""
        done, self.direct = self.direct, None
        if done is not None and not done.query():
            self.stats.slot_waits += 1
            with span("stage.wait"):
                done.synchronize()

    def fetch(self, out: torch.Tensor, k: int):
        """Queue the D2H copy of slot ``k``'s output; returns the host
        tensor and the event that marks it (and the slot's read) done."""
        with span("fetch"):
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
    ``torch.fft`` (``cuda_pfb.pfb_*_torch``). The step is chosen once, at
    construction, by its home: ``cuda_pfb.streaming_step`` with the PFB,
    else ``cuda_power.detect``.

    ``power_fn`` replaces the step (the JAX package's argument of that
    name): ``power_fn(x) -> record``, or with ``pfb_nfft`` a streaming
    ``power_fn(x, carry) -> (record, carry)``, e.g. a per-rank step of
    ``parallel/sharded.py``.
    """

    def __init__(self, device: torch.device | str,
                 power_fn: Callable | None = None, mean: bool = False,
                 depth: int = 2, name: str = "baseband2power",
                 log_dir: str | None = None, nout: int = 1,
                 device_layout: bool = False, stokes: bool = False,
                 pfb_nfft: int = 0, pfb_ntap: int = 4,
                 pfb_window: str = "hamming"):
        if nout < 1:
            raise ValueError(f"nout={nout} must be >= 1")
        self.device = torch.device(device)
        self._nout = nout
        self._device_layout = device_layout
        self._stokes = stokes
        self._depth = max(1, depth)
        layout = "rows" if device_layout else "wire"
        # the PFB route's label, empty without the PFB
        self._pfb_route = "power_fn" if pfb_nfft else ""
        if pfb_nfft and power_fn is not None:
            self._step = power_fn
        elif pfb_nfft:
            self._step, self._pfb_route = CPF.streaming_step(
                pfb_nfft, pfb_ntap, pfb_window, nout, stokes, mean, layout)
        elif power_fn is not None:
            self._step = lambda x, carry: (power_fn(x), carry)
        else:
            self._step = lambda x, carry: (
                CP.detect(x, nout, stokes, layout, mean), carry)
        self._carry = None
        self.log = open_log(name, log_dir)
        if self._pfb_route:
            self.log.info("PFB route: %s", self._pfb_route)

    def power(self, x: torch.Tensor) -> torch.Tensor:
        """One block's record: ``(nchan,)`` or ``(nout, nchan)`` float32,
        with Stokes ``(4, nchan)`` or ``(nout, 4, nchan)``. With the PFB,
        ``nchan`` counts fine channels, Stokes keeps its ``nout`` axis
        (``(1, 4, nchan)`` at ``nout = 1``, as in the JAX package), and
        each call continues the stream from the previous block's carry."""
        with span("step"):
            out, self._carry = self._step(x, self._carry)
            return out

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
        if self._pfb_route:
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
        if not self._pfb_route:
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
        partials0 = sum(CPF.partial_bytes.values())
        depths0 = collections.Counter(CPF.stage_depths)
        lanes0 = collections.Counter(CPF.fft_lane_stages)
        t_start = t_block = time.perf_counter()
        self.log.info("pipeline start: device=%s depth=%d nout=%d layout=%s "
                      "mode=%s", self.device, self._depth, self._nout,
                      "rows" if self._device_layout else "wire", self._mode())

        def drain_one():
            nonlocal t_block
            host, ready = inflight.popleft()
            if ready is not None and not ready.query():
                stats.record_waits += 1
                with span("drain.wait"):
                    ready.synchronize()
            row = host.numpy()
            if debug.debug_enabled():
                # Q, U and V are legitimately negative
                debug.check_power(row, stats.nblocks, signed=self._stokes)
                self.log.info("block %d ok: sum=%.6g max=%.6g",
                              stats.nblocks, row.sum(), row.max())
            with span("sink"):
                sink.write(row)
            now = time.perf_counter()
            stats.block_seconds.append(now - t_block)
            stats.nblocks += 1
            t_block = now

        try:
            blocks = iter(source)
            while True:
                if staging is not None:
                    staging.wait_direct()
                with span("source"):
                    block = next(blocks, None)
                if block is None:
                    break
                if self._device_layout and block.ndim == 2:
                    # rows blocks go H2D 3-D (nseries, ndf, 256)
                    block = block.reshape(block.shape[0], -1, 2 * C.NSAMP_DF)
                if not stats.ndf:
                    stats.ndf = (block.shape[1] if self._device_layout
                                 else block.shape[0])
                if staging is None:
                    staging = _Staging(block.shape, self.device, self._depth,
                                       stats)
                x, slot = staging.put(block)
                inflight.append(staging.fetch(self.power(x), slot))
                stats.nbytes_in += block.nbytes
                while len(inflight) > self._depth:
                    drain_one()
            while inflight:
                drain_one()
            stats.elapsed = time.perf_counter() - t_start
        finally:
            try:
                if staging is not None:
                    # a run that raised: no H2D reads the source's memory
                    # once the run has returned
                    staging.wait_direct()
            finally:
                sink.close()
        stats.kernel_launches = sum(CP.launches.values()) - launches0
        stats.partial_bytes = sum(CPF.partial_bytes.values()) - partials0
        stats.pfb_stage_depths = dict(sorted(
            (CPF.stage_depths - depths0).items()))
        stats.pfb_fft_lane_stages = dict(sorted(
            (CPF.fft_lane_stages - lanes0).items()))
        self.log.info(
            "pipeline done: %d blocks, %.3f s, %.3g samp/s, %.2fx real time, "
            "%d kernel launches, %d partial bytes, PFB launches by stage "
            "depth %s and by FFT lane stages %s, %d slot waits, %d record "
            "waits, %d direct H2D",
            stats.nblocks, stats.elapsed, stats.samples_per_sec,
            stats.realtime_fraction, stats.kernel_launches,
            stats.partial_bytes, stats.pfb_stage_depths,
            stats.pfb_fft_lane_stages, stats.slot_waits, stats.record_waits,
            stats.direct_h2d)
        return stats
