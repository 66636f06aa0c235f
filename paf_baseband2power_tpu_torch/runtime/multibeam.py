"""Multi-beam streaming: several capture streams through one mesh of
ranks.

Counterpart of ``paf_baseband2power_tpu/runtime/multibeam.py``. The
reference serves multiple beams by running disconnected per-beam
pipelines; the JAX package batches B beam streams into one SPMD step over a
``(beam, time, chunk)`` mesh. Here every rank drives its own beams: it
reads their sources, cuts each block to its (time, chunk) shard, runs the
per-rank step of ``make_multibeam_power_step_2d`` (the power kernel, exact
sums all-reduced over time) on its device, and rank 0 gathers each block
row's spectra and writes every beam's sink. Blocks stay in the 2-D wire
layout, as rings and the capture engine deliver them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import cuda_power as CP
from ..parallel.distributed import all_agree, rank_device
from ..parallel.mesh import BEAM_AXIS, axis_index, axis_size
from ..parallel.sharded import (
    gather,
    make_multibeam_power_step_2d,
    shard_block,
)
from .log import open_log
from .pipeline import PipelineStats


def run_multibeam(sources, mesh, sinks, mean: bool = False,
                  log_dir: str | None = None,
                  device: torch.device | str = "cuda") -> PipelineStats:
    """Drive B per-beam block sources through the sharded step.

    ``sources``: per-beam iterables of 2-D int16 blocks ``(ndf, lanes)``
    (every rank gets the list and reads only its own beams). ``sinks``:
    per-beam objects with ``write(power)``/``close()``; rank 0 writes them.
    Streams until the shortest source is exhausted, in lockstep across
    ranks. ``device``: ``"cuda"`` (this rank's card) or ``"cpu"``.
    """
    nbeam = len(sources)
    if nbeam != axis_size(mesh, BEAM_AXIS):
        raise ValueError(
            f"{nbeam} sources != mesh beam axis {axis_size(mesh, BEAM_AXIS)}")
    if len(sinks) != nbeam:
        raise ValueError("one sink per beam required")
    device = (rank_device(device) if isinstance(device, str)
              else torch.device(device))
    log = open_log("multibeam", log_dir)
    step = make_multibeam_power_step_2d(mesh, mean=mean)
    rank0 = torch.distributed.get_rank() == 0
    stats = PipelineStats()
    launches0 = sum(CP.launches.values())
    t0 = time.perf_counter()
    try:
        # the mesh has one beam per beam coordinate: this rank's
        rows_iter = zip(sources[axis_index(mesh, BEAM_AXIS)])
        while True:
            rows = next(rows_iter, None)
            if not all_agree(rows is not None, device):
                break
            if not stats.ndf:
                stats.ndf = rows[0].shape[0]
            stacked = np.stack([np.asarray(r).reshape(stats.ndf, -1)
                                for r in rows])
            # this rank's (time, chunk) shard of its beam's block
            x = shard_block(stacked, mesh, (None,) + step.in_spec[1:])
            out = gather(step(torch.from_numpy(x).to(device)), mesh,
                         step.out_spec)
            if rank0:
                for b, sink in enumerate(sinks):
                    sink.write(out[b].numpy())
            stats.nblocks += 1
            stats.nbytes_in += stacked.nbytes * nbeam
        stats.elapsed = time.perf_counter() - t0
    finally:
        for sink in sinks:
            sink.close()
    stats.kernel_launches = sum(CP.launches.values()) - launches0
    log.info("multibeam done: %d beams x %d blocks, %.3f s, %.2fx real time, "
             "%d kernel launches", nbeam, stats.nblocks, stats.elapsed,
             stats.realtime_fraction, stats.kernel_launches)
    return stats

