"""Multi-host streaming runtime: one rank per device, each feeding its own
slice; rank 0 sinks.

Counterpart of ``paf_baseband2power_tpu/runtime/multihost.py``. The
reference scales across hosts by running disconnected per-node pipelines
partitioned by UDP addressing (``capture.c:570-584``,
``paf_capture.c:114-118``) — there is no cross-node backend at all. The
JAX package forms one SPMD program over every host; here every rank of a
``torch.distributed`` job runs

    rank k feeder (ring / file / synthetic, its own slice only)
        -> its device                        (no cross-rank copy)
        -> the per-rank sharded step         (CUDA kernels; partials
                                              all-reduced over time)
        -> spectra gathered onto rank 0, which sinks them

Slice ownership follows the mesh: rank boundaries land on the (beam, time)
axes (``parallel.distributed.global_mesh``), and
``process_block_slice`` tells each rank's feeder which (beam, frame,
chunk) range to produce. Ingest therefore needs no data movement between
ranks — only the partial spectra cross them.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..ops import cuda_power as CP
from ..parallel.distributed import (
    all_agree,
    global_mesh,
    init_distributed,
    process_block_slice,
    rank_device,
)
from ..parallel.mesh import TIME_AXIS, axis_size, mesh_shape
from ..parallel.sharded import (
    gather,
    make_multibeam_composed_step_2d,
    make_multibeam_pfb_step_2d,
    make_multibeam_power_step_2d,
    make_multibeam_rows_step,
)
from .log import open_log
from .pipeline import PipelineStats


class MultihostRunner:
    """Run this rank's slice of every global block through the sharded
    step and stream.

    ``nbeam_total`` beams x ``ndf`` frames x ``nchk`` chunks per global
    block; the local feeder supplies only this rank's ``(beam, frame,
    chunk)`` slice, in the 2-D wire layout ``(nbeam_l, ndf_l, nchk_l *
    3584)`` or, with ``device_layout``, as series rows ``(nbeam_l, nchk_l *
    14, ndf, 256)``. ``platform``: ``"cuda"`` (the rank's card) or
    ``"cpu"``; ``backend``: the process group's, ``"nccl"`` or ``"gloo"``
    (``parallel/distributed.py``).
    """

    def __init__(self, nbeam_total: int = 1, ndf: int = C.NDF_BLK,
                 nchk: int = C.NCHK_NIC, n_beam_mesh: int | None = None,
                 mean: bool = False, log_dir: str | None = None,
                 pfb_nfft: int = 0, pfb_ntap: int = 4,
                 stokes: bool = False, nout: int = 1,
                 device_layout: bool = False,
                 scatter_output: bool = False, platform: str = "cuda",
                 backend: str = "nccl"):
        init_distributed(backend)
        self.backend = backend
        self.device = rank_device(platform)
        self.nbeam_total = nbeam_total
        self.ndf, self.nchk = ndf, nchk
        self.device_layout = device_layout
        # fine-channel modes stream: the overlap-save carry stays on each
        # rank's device between blocks, so an N-rank stream is block for
        # block the single-device streaming pipeline
        self._stateful = bool(pfb_nfft)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        world = self.world
        n_beam_mesh = n_beam_mesh or min(nbeam_total, world)
        self.log = open_log(f"multihost_p{self.rank}", log_dir)
        if device_layout:
            # rows beam-DP x series-TP: the chunk axis takes the ranks
            # beyond the beams, at the largest extent that keeps whole
            # frequency chunks per shard; frames never split (a time
            # extent above 1 replicates blocks and their compute)
            avail = world // n_beam_mesh
            n_chunk = avail
            while n_chunk > 1 and (nchk % n_chunk or avail % n_chunk):
                n_chunk -= 1
            self.mesh = global_mesh(n_beam=n_beam_mesh, n_chunk=n_chunk)
            self.step = make_multibeam_rows_step(
                self.mesh, nfft=pfb_nfft, ntap=pfb_ntap, nout=nout,
                stokes=stokes, mean=mean, streaming=self._stateful)
            (b0, b1), _, chunks = process_block_slice(
                self.mesh, nbeam_total, ndf, nchk)
            self.slice = ((b0, b1), (0, ndf), chunks)
            waste = axis_size(self.mesh, TIME_AXIS)
            if waste > 1:
                self.log.warning(
                    "device_layout shards beams x series only: the "
                    "mesh's time extent (%d) replicates every block and "
                    "its compute %d-fold — increase beams or pick nchk "
                    "divisible by the rank count", waste, waste)
        else:
            self.mesh = global_mesh(n_beam=n_beam_mesh)
            if stokes or nout > 1:
                # composed detection across ranks (PFB x Stokes x
                # tscrunch); scatter_output reduce-scatters the waterfall
                # over time (gather reassembles it for the sink)
                self.step = make_multibeam_composed_step_2d(
                    self.mesh, nfft=pfb_nfft, ntap=pfb_ntap, nout=nout,
                    stokes=stokes, mean=mean, streaming=self._stateful,
                    scatter_output=scatter_output and bool(pfb_nfft))
            elif pfb_nfft:
                # the overlap-save halo crosses ranks on the time axis;
                # the cross-block carry streams through run()
                self.step = make_multibeam_pfb_step_2d(
                    self.mesh, nfft=pfb_nfft, ntap=pfb_ntap, mean=mean,
                    streaming=True)
            else:
                self.step = make_multibeam_power_step_2d(self.mesh,
                                                         mean=mean)
            self.slice = process_block_slice(self.mesh, nbeam_total, ndf,
                                             nchk)
        self.log.info(
            "multihost: rank %d/%d (%s) on %s, mesh %s, local slice "
            "beams=%s frames=%s chunks=%s", self.rank, world, backend,
            self.device, mesh_shape(self.mesh), *self.slice)

    @property
    def local_shape(self) -> tuple[int, ...]:
        (b0, b1), (f0, f1), (c0, c1) = self.slice
        if self.device_layout:
            return (b1 - b0, (c1 - c0) * C.NCHAN_CHK * C.NPOL_SAMP,
                    f1 - f0, 2 * C.NSAMP_DF)
        return (b1 - b0, f1 - f0, (c1 - c0) * C.DT_SIZE // 2)

    def assemble(self, local_block: np.ndarray) -> torch.Tensor:
        """This rank's slice -> its shard on its device (the slice is the
        shard: no data moves between ranks)."""
        if tuple(local_block.shape) != self.local_shape:
            raise ValueError(
                f"local block {local_block.shape} != owned slice "
                f"{self.local_shape}")
        return torch.from_numpy(np.ascontiguousarray(local_block)).to(
            self.device)

    def run(self, local_source: Iterable[np.ndarray],
            sink=None) -> PipelineStats:
        """Stream this rank's slices; rank 0 writes the gathered spectra,
        one record per beam per block.

        ``local_source`` yields this rank's slice of each global block, in
        lockstep across ranks (every rank takes part in every collective;
        the stream ends when any rank's source ends).
        """
        stats = PipelineStats()
        stats.ndf = self.ndf
        rank0 = dist.get_rank() == 0
        launches0 = sum(CP.launches.values())
        t0 = time.perf_counter()
        carry = None
        it = iter(local_source)
        try:
            while True:
                local = next(it, None)
                if not all_agree(local is not None, self.device):
                    break
                x = self.assemble(local)
                if self._stateful:
                    out, carry = self.step(x, carry)
                else:
                    out = self.step(x)
                rows = gather(out, self.mesh, self.step.out_spec)
                if rank0 and sink is not None:
                    for b in range(self.nbeam_total):
                        sink.write(rows[b].numpy())
                stats.nblocks += 1
                stats.nbytes_in += local.nbytes * dist.get_world_size()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stats.elapsed = time.perf_counter() - t0
        finally:
            if sink is not None and rank0:
                sink.close()
        stats.kernel_launches = sum(CP.launches.values()) - launches0
        self.log.info(
            "multihost done: %d blocks, %.3f s, %.2fx real time, %d kernel "
            "launches", stats.nblocks, stats.elapsed,
            stats.realtime_fraction, stats.kernel_launches)
        return stats


def synthetic_local_source(runner: MultihostRunner, nblocks: int,
                           seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic per-rank slice source (test/demo feeder).

    Every rank generates the same global blocks (seeded per beam+block)
    and keeps only its owned slice — so N-rank output is comparable with a
    single-process run over the same seeds. With a ``device_layout``
    runner the slices are series-row blocks (whole frames).
    """
    from ..ops.frame import block_to_rows, synthetic_block

    (b0, b1), (f0, f1), (c0, c1) = runner.slice
    for i in range(nblocks):
        beams = []
        for b in range(b0, b1):
            blk = synthetic_block(rng=seed + 1000 * b + i, ndf=runner.ndf,
                                  nchk=runner.nchk)[f0:f1, c0:c1]
            beams.append(block_to_rows(blk) if runner.device_layout
                         else blk.reshape(f1 - f0, -1))
        yield np.stack(beams)


def file_local_source(runner: MultihostRunner,
                      paths: list[str]) -> Iterator[np.ndarray]:
    """Per-rank slice source from recordings, one ``.dada`` file per beam
    (a shared filesystem's): each rank reads only its own bytes of each
    block — a frame range of a wire block, a series range of a rows block
    (``ORDER SERIES``), which must match ``runner.device_layout``."""
    from ..io.dada import DadaFileReader

    if len(paths) != runner.nbeam_total:
        raise ValueError(f"{len(paths)} recordings for "
                         f"{runner.nbeam_total} beams")
    (b0, b1), _, _ = runner.slice
    block_nbytes = runner.ndf * runner.nchk * C.DT_SIZE
    files = []
    for path in paths[b0:b1]:
        with DadaFileReader(path) as r:
            rows = (r.header or {}).get("ORDER") == "SERIES"
            nblocks = r.payload_bytes // block_nbytes
        if rows != runner.device_layout:
            raise ValueError(
                f"{path} holds ORDER={'SERIES' if rows else 'TF'} blocks "
                f"but device_layout={runner.device_layout} — pass the flag "
                "matching the recording's layout")
        files.append((path, nblocks))
    return _read_slices(runner, [p for p, _ in files],
                        min(n for _, n in files))


def _read_slices(runner, paths, nblocks) -> Iterator[np.ndarray]:
    _, (f0, f1), (c0, c1) = runner.slice
    ndf, nchk = runner.ndf, runner.nchk
    block_nbytes = ndf * nchk * C.DT_SIZE
    lanes = nchk * C.DT_SIZE // 2
    for i in range(nblocks):
        beams = []
        for path in paths:
            base = C.DADA_HDR_SIZE + i * block_nbytes
            if runner.device_layout:
                seg = ndf * 2 * C.NSAMP_DF            # int16 per series
                s0 = c0 * C.NCHAN_CHK * C.NPOL_SAMP
                n = (c1 - c0) * C.NCHAN_CHK * C.NPOL_SAMP
                x = np.fromfile(path, dtype="<i2", count=n * seg,
                                offset=base + s0 * seg * 2)
                beams.append(x.reshape(n, ndf, 2 * C.NSAMP_DF))
            else:
                x = np.fromfile(path, dtype="<i2", count=(f1 - f0) * lanes,
                                offset=base + f0 * lanes * 2)
                x = x.reshape(f1 - f0, lanes)
                per = C.DT_SIZE // 2
                beams.append(np.ascontiguousarray(x[:, c0 * per:c1 * per]))
        yield np.stack(beams)
