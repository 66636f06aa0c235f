"""Per-rank multi-device steps: the ``shard_map`` pipelines of the JAX
package with one rank per device.

Counterpart of ``paf_baseband2power_tpu/parallel/sharded.py``: the same
twelve factories under the same names, with the same validation. JAX runs
one program over the mesh; here each factory returns the step of one rank,
which takes this rank's shard of the global input and returns its shard of
the global output. ``shard_block`` cuts the shard out of a global array
and ``gather`` assembles the global output on rank 0, both by the
partition spec the step carries (``step.in_spec``, ``step.out_spec``, and
for a streaming step ``step.history_spec``): a tuple of one mesh axis name
or None per leading dimension, as JAX's ``PartitionSpec``. The same
global inputs, cut by the same specs, give the same global outputs as the
JAX step.

Each shard body runs the package's kernels: ``ops/cuda_power.py`` for
power and Stokes (K1-K8), ``ops/cuda_pfb.py`` for the PFB (K9, K10, or the
torch.fft route for the shapes the kernel does not take, chosen by shape
alone); on CPU tensors their plain versions. The collectives:

  * ``psum`` over time -> ``all_reduce`` of the partials. Power and Stokes
    reduce the kernels' exact int64 sums and finish after, so the records
    are bit-equal to the single-device ones and to the golden model.
  * the ``ppermute`` halo -> each time shard sends its last ``(ntap-1) *
    nfft`` samples to the next shard, which runs the PFB kernel with them
    as its overlap-save carry: it then computes the windows that end in
    its first ``ntap - 1`` slots. Shard 0 takes the stream's carry, or
    none one-shot. Every window ends in the same global slot as in the
    JAX package's halo scheme, so window counts and groups agree.
  * ``psum_scatter`` -> ``reduce_scatter`` (``scatter_output``).
  * ``_tail_carry`` -> a broadcast of the last time shard's tail. The
    carry is this package's int16 ``(nseries, halo, 2)`` form
    (``ops/pfb.py``), sharded over ``chunk``, replicated over ``time``.

An axis of extent 1 needs no collective, so at world size 1 every step is
the single-device kernel call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import NCHAN_CHK, NPOL_SAMP, NSAMP_DF
from ..ops import cuda_pfb as CPF
from ..ops import cuda_power as CP
from ..ops import pfb as PF
from ..ops import power as P
from .distributed import AxisGroup
from .mesh import BEAM_AXIS, CHUNK_AXIS, TIME_AXIS, axis_index, axis_size

BLOCK_SPEC = (TIME_AXIS, CHUNK_AXIS)


def _spec_step(step, in_spec, out_spec, history_spec=None):
    step.in_spec, step.out_spec = in_spec, out_spec
    step.history_spec = history_spec
    return step


def _contiguous(x):
    return x.contiguous() if torch.is_tensor(x) else np.ascontiguousarray(x)


def shard_block(block, mesh, spec=BLOCK_SPEC):
    """This rank's shard of a global array (numpy or tensor) under
    ``spec`` (default: frames over ``time``, lanes or chunks over
    ``chunk``), contiguous."""
    x = block
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} ({size}) does not split {n} "
                             f"ways over the '{axis}' axis")
        cut = [slice(None)] * dim + [slice(i * (size // n),
                                           (i + 1) * (size // n))]
        x = x[tuple(cut)]
    return _contiguous(x)


def gather(local: torch.Tensor, mesh, spec) -> torch.Tensor | None:
    """Assemble the global array on rank 0 (a CPU tensor) from every
    rank's shard under ``spec``; None on the other ranks. Every rank must
    call it."""
    import torch.distributed as dist

    world = dist.get_world_size()
    w = local.detach().contiguous()
    if dist.get_backend() != "nccl":
        w = w.cpu()
    if world == 1:
        return w.cpu()
    rank = dist.get_rank()
    parts = [torch.empty_like(w) for _ in range(world)] if rank == 0 else None
    dist.gather(w, parts, dst=0)
    if rank != 0:
        return None
    names = mesh.mesh_dim_names
    shape = list(w.shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            shape[dim] *= axis_size(mesh, axis)
    out = torch.empty(shape, dtype=w.dtype)
    grid = mesh.mesh
    for r, part in enumerate(parts):
        coord = dict(zip(names, (grid == r).nonzero()[0].tolist()))
        cut = []
        for dim, axis in enumerate(spec):
            if axis is None:
                cut.append(slice(None))
            else:
                n = w.shape[dim]
                cut.append(slice(coord[axis] * n, (coord[axis] + 1) * n))
        out[tuple(cut)] = part.cpu()
    return out


def _wire_2d(block: torch.Tensor) -> torch.Tensor:
    """A wire shard, 6-D ``(ndf, nchk, 128, 7, 2, 2)`` or 2-D, as 2-D."""
    return block.reshape(block.shape[0], -1)


def _check_window_aligned(nout: int, n_time: int) -> None:
    if nout % n_time:
        raise ValueError(
            f"nout={nout} must be a multiple of the time-shard count "
            f"{n_time} (windows may not straddle shards)")


def _reduced_detect(blocks, time: AxisGroup, stokes: bool,
                    mean: bool) -> torch.Tensor:
    """Power or Stokes of this rank's beams of wire shards ``(nbeam_l,
    ndf_l, lanes_l)``: exact sums per beam, all-reduced over time, then
    finished. ``(nbeam_l, [4,] nchan_l)``."""
    sums = torch.stack([CP.detect_sums(b, 1, stokes=stokes)[0]
                        for b in blocks])
    sums = time.all_reduce(sums)
    ndf = blocks[0].shape[0] * time.size
    divisor = None
    if mean:
        divisor = P.stokes_mean_divisor(ndf) if stokes else P.mean_divisor(ndf)
    return CP.finish_sums(sums, stokes=stokes, divisor=divisor)


def make_sharded_power_step(mesh, mean: bool = False):
    """The per-rank multi-device power step.

    Input: this rank's shard of a canonical int16 block, 6-D or wire 2-D,
    ``P(time, chunk)``. Each rank integrates its sub-block, then the exact
    partial sums are all-reduced over the time axis. Output: float32
    power ``(nchk_l * 7,)``, the ``P(chunk)`` shard of ``(nchk * 7,)``.
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step(block):
        return _reduced_detect([_wire_2d(block)], time, False, mean)[0]

    return _spec_step(step, BLOCK_SPEC, (CHUNK_AXIS,))


def make_multibeam_power_step(mesh, mean: bool = False):
    """Multi-beam power step on a ``(beam, time, chunk)`` mesh.

    Input: this rank's shard of int16 blocks ``(nbeam, ndf, nchk, nsamp,
    nchan, npol, ndim)``, ``P(beam, time, chunk)``. Beams are data
    parallel; partial sums all-reduce over ``time`` only. Output
    ``(nbeam_l, nchan_l)`` float32, the ``P(beam, chunk)`` shard.
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step(blocks):
        return _reduced_detect([_wire_2d(b) for b in blocks], time, False,
                               mean)

    return _spec_step(step, (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
                      (BEAM_AXIS, CHUNK_AXIS))


def make_multibeam_power_step_2d(mesh, mean: bool = False):
    """Multi-beam power step on the production 2-D-per-beam layout.

    Input: this rank's shard of int16 blocks ``(nbeam, ndf, nchk * 3584)``,
    ``P(beam, time, chunk)`` — per-beam blocks as ring buffers and the
    capture engine deliver them, stacked. The JAX package computes this
    shard body in XLA; here it is the power kernel (K1) per beam. Output
    ``(nbeam_l, nchk_l * 7)`` float32, the ``P(beam, chunk)`` shard.
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step(blocks):
        return _reduced_detect(list(blocks), time, False, mean)

    return _spec_step(step, (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
                      (BEAM_AXIS, CHUNK_AXIS))


def make_sharded_stokes_step(mesh, mean: bool = False):
    """Multi-device full-Stokes step on the 2-D layout.

    Input: this rank's int16 ``(ndf_l, nchk_l * 3584)`` shard, ``P(time,
    chunk)``; the exact per-shard Stokes sums all-reduce over time. Output
    ``(4, nchan_l)``, the ``P(None, chunk)`` shard. Definitions:
    ``ops.golden.baseband2stokes_golden``.
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step(block):
        return _reduced_detect([_wire_2d(block)], time, True, mean)[0]

    return _spec_step(step, BLOCK_SPEC, (None, CHUNK_AXIS))


def make_sharded_scrunch_step(mesh, nout: int, mean: bool = False):
    """Multi-device sub-block integration: ``nout`` spectra per block.

    Requires the time shards to align with integration windows
    (``n_time | nout``): each shard then owns whole windows and the step
    needs NO collectives at all. Output ``(nout / n_time, nchan_l)``, the
    ``P(time, chunk)`` shard of ``(nout, nchan)``.
    """
    n_time = axis_size(mesh, TIME_AXIS)
    _check_window_aligned(nout, n_time)

    def step(block):
        return CP.baseband2power_scrunch_cuda(_wire_2d(block), nout // n_time,
                                              mean=mean)

    return _spec_step(step, BLOCK_SPEC, (TIME_AXIS, CHUNK_AXIS))


def make_sharded_stokes_scrunch_step(mesh, nout: int, mean: bool = False):
    """Multi-device Stokes x sub-block integration (coarse channels).

    Window-aligned like ``make_sharded_scrunch_step`` (``n_time | nout``:
    shards own whole windows, zero collectives). Output ``(nout / n_time,
    4, nchan_l)``, the ``P(time, None, chunk)`` shard.
    """
    n_time = axis_size(mesh, TIME_AXIS)
    _check_window_aligned(nout, n_time)

    def step(block):
        return CP.baseband2stokes_scrunch_cuda(_wire_2d(block),
                                               nout // n_time, mean=mean)

    return _spec_step(step, BLOCK_SPEC, (TIME_AXIS, None, CHUNK_AXIS))


# --- the PFB across time shards ---------------------------------------------

def _pfb_beams(blocks, time: AxisGroup, nfft: int, ntap: int, window: str,
               nout: int, stokes: bool, mean: bool, shift: bool,
               history, return_history: bool,
               scatter_output: bool = False):
    """The composed PFB shard body over this rank's beams: overlap-save
    halo from the previous time shard, per-window detection into global
    end-slot groups, a reduction over time, normalization.

    ``blocks``: this rank's wire shards, one per local beam; ``history``:
    the stream's carry per beam, or None. Returns ``(out, carry)``:
    ``out`` ``(nbeam_l, nout_l, ns, nchan_l * nfft)`` float32 (``nout_l``
    is ``nout / n_time`` with ``scatter_output``, ns 4 or 1) and the new
    carry per beam (or None).
    """
    n_time = time.size
    halo = (ntap - 1) * nfft
    _, ndf, _ = PF.block_geometry(blocks[0], "wire")
    nsamp = ndf * NSAMP_DF
    if nsamp % nfft:
        raise ValueError(f"nfft={nfft} must divide the {nsamp} samples per "
                         "time shard")
    nblk_l = nsamp // nfft
    slots_total = n_time * nblk_l
    if slots_total % nout:
        raise ValueError(f"nout={nout} must divide {slots_total} slots")
    wpg = slots_total // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(f"windows per spectrum {wpg} < ntap-1")
    streaming = history is not None or return_history
    if streaming and nsamp < halo:
        raise ValueError(
            f"streaming needs >= (ntap-1)*nfft={halo} samples per "
            f"time shard, got {nsamp}")
    if n_time > 1 and nsamp < halo:
        raise ValueError(
            f"the overlap-save halo needs >= (ntap-1)*nfft={halo} samples "
            f"per time shard, got {nsamp}")
    # the kernel groups this shard's windows by end slot in runs of d
    # slots; each run lies in one global group
    d = math.gcd(nblk_l, wpg)
    if d < max(ntap - 1, 1):
        raise ValueError(
            f"time shards of {nblk_l} slots against spectra of {wpg}: runs "
            f"of {d} slots < ntap-1 windows; pick nout or the time-shard "
            "count so that they align")
    nsub = nblk_l // d
    power_fn, spectra_fn, _ = CPF.route(nfft, ntap)
    tails = None
    if n_time > 1 or return_history:
        tails = torch.stack([PF.pfb_history(b, nfft, ntap)
                             for b in blocks])
    prev = time.shift_up(tails) if n_time > 1 else None
    if time.index == 0:
        prev = history
    first = time.index * nblk_l
    groups = torch.tensor([(first + k * d) // wpg for k in range(nsub)],
                          device=blocks[0].device)
    outs = []
    for i, b in enumerate(blocks):
        h = None if prev is None else prev[i]
        kw = dict(window=window, mean=False, shift=shift, history=h)
        if nsub == 1 and not stokes:
            sub = power_fn(b, nfft, ntap, **kw)[None, None]
        else:
            sub = spectra_fn(b, nfft, ntap, nout=nsub, stokes=stokes, **kw)
            if not stokes:
                sub = sub[:, None]
        g = sub.new_zeros((nout,) + tuple(sub.shape[1:]))
        outs.append(g.index_add_(0, groups, sub))
    g = torch.stack(outs, dim=1)                 # (nout, nbeam_l, ns, F)
    nout_l = nout
    if scatter_output and n_time > 1:
        g = time.reduce_scatter(g)
        nout_l = nout // n_time
    else:
        g = time.all_reduce(g)
    if mean:
        div = PF.mean_divisors(nout, wpg, ntap, stokes, history is not None)
        if nout_l != nout:
            div = div[time.index * nout_l:(time.index + 1) * nout_l]
        g = g / torch.tensor(div, dtype=g.dtype, device=g.device)[
            :, None, None, None]
    carry = time.broadcast_from_last(tails) if return_history else None
    return g.transpose(0, 1), carry


def _streaming(step1, streaming: bool):
    """``step(x, history=None) -> (out, new_history)`` when streaming,
    else ``step(x) -> out``."""
    if streaming:
        return lambda x, history=None: step1(x, history, True)
    return lambda x: step1(x, None, False)


def make_sharded_spectra_step(mesh, nfft: int, ntap: int = 4,
                              window: str = "hamming", nout: int = 1,
                              stokes: bool = False, mean: bool = False,
                              shift: bool = True, streaming: bool = False,
                              scatter_output: bool = False):
    """Multi-device composed fine-channel detection: PFB x tscrunch
    waterfall x Stokes.

    Communication: the overlap-save halo sent to the next time shard plus
    one all-reduce of the grouped spectra over time (output groups need
    not align with shards). Output: the ``P([time,] None, chunk)`` shard
    of ``(nout, [4,] nchk * 7 * nfft)`` float32.

    ``streaming``: ``step(block, history=None) -> (out, new_history)``,
    the int16 carry ``(nseries_l, halo, 2)`` sharded over ``chunk`` —
    spectrum 0 of every non-first block then holds its full window count.

    ``scatter_output``: reduce-scatter the grouped spectra over time
    instead of all-reducing (requires ``n_time | nout``): each time shard
    keeps its contiguous ``nout / n_time`` spectra, ``P(time, ...)``.
    """
    n_time = axis_size(mesh, TIME_AXIS)
    if scatter_output and nout % n_time:
        raise ValueError(
            f"scatter_output needs n_time | nout (nout={nout}, "
            f"n_time={n_time})")
    time = AxisGroup(mesh, TIME_AXIS)
    nout_ax = TIME_AXIS if scatter_output and n_time > 1 else None
    out_spec = ((nout_ax, None, CHUNK_AXIS) if stokes
                else (nout_ax, CHUNK_AXIS))

    def step1(block, history, return_history):
        out, carry = _pfb_beams(
            [_wire_2d(block)], time, nfft, ntap, window, nout, stokes,
            mean, shift, None if history is None else history[None],
            return_history, scatter_output)
        out = out[0] if stokes else out[0, :, 0]
        return (out, carry[0]) if return_history else out

    return _spec_step(_streaming(step1, streaming), BLOCK_SPEC, out_spec,
                      (CHUNK_AXIS,) if streaming else None)


def make_sharded_pfb_step(mesh, nfft: int, ntap: int = 4,
                          window: str = "hamming", mean: bool = False,
                          shift: bool = True, streaming: bool = False):
    """The per-rank multi-device PFB spectrometer step.

    Each time shard channelizes its sub-block with the previous shard's
    last ``(ntap-1)*nfft`` samples as its carry (the halo, sent over the
    time group), so it computes every window that ends in its own slots;
    shard 0 has none one-shot, matching the golden model's window count.
    Partial spectra are then all-reduced over the time axis.

    Output: float32 ``(nchk_l * 7 * nfft,)``, the ``P(chunk)`` shard.

    ``streaming``: ``step(block, history=None) -> (power, new_history)``
    — the carry is the block's global trailing ``(ntap-1)*nfft`` samples,
    int16 ``(nseries_l, halo, 2)``, sharded over ``chunk`` and replicated
    over ``time``; with it shard 0 computes the windows straddling the
    previous block, so an N-rank stream of K blocks sums to the one-shot
    golden over the concatenated series.
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step1(block, history, return_history):
        out, carry = _pfb_beams(
            [_wire_2d(block)], time, nfft, ntap, window, 1, False,
            mean, shift, None if history is None else history[None],
            return_history)
        out = out[0, 0, 0]
        return (out, carry[0]) if return_history else out

    return _spec_step(_streaming(step1, streaming), BLOCK_SPEC,
                      (CHUNK_AXIS,), (CHUNK_AXIS,) if streaming else None)


def make_multibeam_pfb_step_2d(mesh, nfft: int, ntap: int = 4,
                               window: str = "hamming", mean: bool = False,
                               shift: bool = True, streaming: bool = False):
    """PFB spectrometer on the production multi-host mesh: 2-D-per-beam
    blocks ``(nbeam, ndf, nchk * 3584)`` sharded ``P(beam, time, chunk)``.

    The per-beam body is ``make_sharded_pfb_step``'s (halo to the next
    time shard, all-reduce of partial spectra), over this rank's beams,
    with one collective of each kind for all of them. Output the ``P(beam,
    chunk)`` shard of ``(nbeam, nchk * 7 * nfft)``.

    ``streaming``: ``step(blocks, history=None) -> (out, new_history)``
    with a per-beam int16 carry ``(nbeam, nseries, halo, 2)`` sharded
    ``P(beam, chunk)`` (replicated over time).
    """
    time = AxisGroup(mesh, TIME_AXIS)

    def step1(blocks, history, return_history):
        out, carry = _pfb_beams(list(blocks), time, nfft, ntap, window, 1,
                                False, mean, shift, history, return_history)
        out = out[:, 0, 0]
        return (out, carry) if return_history else out

    return _spec_step(_streaming(step1, streaming),
                      (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
                      (BEAM_AXIS, CHUNK_AXIS),
                      (BEAM_AXIS, CHUNK_AXIS) if streaming else None)


def make_multibeam_composed_step_2d(mesh, nfft: int = 0, ntap: int = 4,
                                    window: str = "hamming", nout: int = 1,
                                    stokes: bool = False, mean: bool = False,
                                    shift: bool = True,
                                    streaming: bool = False,
                                    scatter_output: bool = False):
    """Composed detection on the multi-host mesh: 2-D-per-beam blocks
    sharded ``P(beam, time, chunk)``, any combination of PFB x Stokes x
    tscrunch.

    With ``nfft``: the ``make_sharded_spectra_step`` body over this rank's
    beams — the ``P(beam, [time,] None, chunk)`` shard of ``(nbeam, nout,
    [4,] nchan * nfft)``. Without ``nfft``: Stokes with exact sums
    all-reduced over time (``nout`` 1), or window-aligned sub-block
    detection (``n_time | nout``, zero collectives) sharded over ``time``
    on the spectra axis. Used by ``runtime/multihost.py`` for the composed
    CLI modes.
    """
    n_time = axis_size(mesh, TIME_AXIS)
    if streaming and not nfft:
        raise ValueError(
            "streaming carries exist only for fine-channel (nfft > 0) "
            "modes — coarse-channel detection has no cross-block state")
    if scatter_output and not nfft:
        raise ValueError(
            "scatter_output applies to the fine-channel waterfall psum "
            "(nfft > 0); coarse-channel modes have no time-axis "
            "allreduce to scatter")
    if scatter_output and nout % n_time:
        raise ValueError(
            f"scatter_output needs n_time | nout (nout={nout}, "
            f"n_time={n_time})")
    in_spec = (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS)
    time = AxisGroup(mesh, TIME_AXIS)
    if not nfft and nout == 1:
        if not stokes:
            raise ValueError(
                "nfft=0, nout=1, stokes=False is plain power — use "
                "make_multibeam_power_step_2d (this factory's nfft=0 "
                "branches are the Stokes/scrunch compositions)")

        def stokes_step(blocks):
            return _reduced_detect(list(blocks), time, True, mean)

        return _spec_step(stokes_step, in_spec,
                          (BEAM_AXIS, None, CHUNK_AXIS))
    if not nfft:
        _check_window_aligned(nout, n_time)
        fn = (CP.baseband2stokes_scrunch_cuda if stokes
              else CP.baseband2power_scrunch_cuda)

        def scrunch_step(blocks):
            return torch.stack([fn(b, nout // n_time, mean=mean)
                                for b in blocks])

        return _spec_step(scrunch_step, in_spec,
                          (BEAM_AXIS, TIME_AXIS, None, CHUNK_AXIS) if stokes
                          else (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS))

    nout_ax = TIME_AXIS if scatter_output and n_time > 1 else None
    out_spec = ((BEAM_AXIS, nout_ax, None, CHUNK_AXIS) if stokes
                else (BEAM_AXIS, nout_ax, CHUNK_AXIS))

    def step1(blocks, history, return_history):
        out, carry = _pfb_beams(list(blocks), time, nfft, ntap, window, nout,
                                stokes, mean, shift, history, return_history,
                                scatter_output)
        out = out if stokes else out[:, :, 0]
        return (out, carry) if return_history else out

    return _spec_step(_streaming(step1, streaming), in_spec, out_spec,
                      (BEAM_AXIS, CHUNK_AXIS) if streaming else None)


# --- series rows: zero collectives ------------------------------------------

def _rows_detect(rows: torch.Tensor, history, return_history: bool,
                 nfft: int, ntap: int, window: str, nout: int, stokes: bool,
                 mean: bool, shift: bool):
    """One rows block (any number of whole chunks) through the rows
    kernels: the PFB (K10) with ``nfft``, else power (K4) or Stokes
    (K7/K8)."""
    if nfft:
        return CPF.pfb_spectra_cuda(
            rows, nfft, ntap, window=window, nout=nout, stokes=stokes,
            mean=mean, shift=shift, history=history,
            return_history=return_history, layout="rows")
    fn = (CP.baseband2stokes_scrunch_rows_cuda if stokes
          else CP.baseband2power_scrunch_rows_cuda)
    return fn(rows, nout, mean=mean)


def _check_rows_factory(nfft: int, ntap: int, streaming: bool) -> None:
    if streaming and not nfft:
        raise ValueError(
            "streaming carries exist only for fine-channel (nfft > 0) "
            "modes — coarse-channel detection has no cross-block state")
    if nfft:    # rows take the kernel's shapes only
        PF.check_rows_nfft(nfft)
        PF.check_rows_ntap(ntap)


def make_multibeam_rows_step(mesh, nfft: int = 0, ntap: int = 4,
                             window: str = "hamming", nout: int = 1,
                             stokes: bool = False, mean: bool = False,
                             shift: bool = True, streaming: bool = False):
    """Beam-parallel detection on device-layout (series-row) blocks.

    A beam-stacked rows block ``(nbeam, nseries, ndf, 256) int16`` is, per
    beam, what a ``capture --device-layout`` ring holds, and every rows
    kernel is series-major — so each rank runs the rows kernels on its
    beams (concatenated on the series axis: one launch) with ZERO
    collectives (the reference's scale-out model: one independent pipeline
    per beam/node, ``paf_capture.c:114-118``). ``nfft`` > 0 for the
    fine-channel spectrometer, else power / Stokes (x tscrunch).

    The series axis additionally shards over ``chunk``, so meshes with
    more ranks than beams still use every device; each shard must hold
    whole frequency chunks. The time axis replicates. Output: the
    ``P(beam, None, [None,] chunk)`` shard of ``(nbeam, nout, [4,]
    nchan * max(nfft, 1))`` float32.

    ``streaming`` (``nfft`` > 0 only): ``step(blocks, history=None) ->
    (out, new_history)``, the int16 carry ``(nbeam, nseries, halo, 2)``
    sharded like the blocks: a slice of each shard's own input, so rows
    streaming needs ZERO collectives.
    """
    _check_rows_factory(nfft, ntap, streaming)
    out_spec = ((BEAM_AXIS, None, None, CHUNK_AXIS) if stokes
                else (BEAM_AXIS, None, CHUNK_AXIS))

    def step1(blocks, history, return_history):
        nbeam_l, nseries, ndf, lanes = blocks.shape
        if nseries % (NCHAN_CHK * NPOL_SAMP):
            raise ValueError(
                f"series shard {nseries} must hold whole frequency "
                f"chunks ({NCHAN_CHK * NPOL_SAMP} series each): use a "
                "chunk mesh extent dividing nchk")
        stacked = blocks.reshape(nbeam_l * nseries, ndf, lanes)
        h = (None if history is None
             else history.reshape((nbeam_l * nseries,) + history.shape[2:]))
        out = _rows_detect(stacked, h, return_history, nfft, ntap, window,
                           nout, stokes, mean, shift)
        if return_history:
            out, h = out
            h = h.reshape((nbeam_l, nseries) + h.shape[1:])
        lead = out.shape[:-1]
        out = out.reshape(tuple(lead) + (nbeam_l, -1)).movedim(-2, 0)
        return (out, h) if return_history else out

    return _spec_step(_streaming(step1, streaming), (BEAM_AXIS, CHUNK_AXIS),
                      out_spec, (BEAM_AXIS, CHUNK_AXIS) if streaming else None)


def make_sharded_rows_step(mesh, nfft: int = 0, ntap: int = 4,
                           window: str = "hamming", nout: int = 1,
                           stokes: bool = False, mean: bool = False,
                           shift: bool = True, streaming: bool = False):
    """Single-beam multi-device detection on a device-layout block: the
    series axis is the natural tensor-parallel axis of the rows form —
    every kernel (power, Stokes, the fine-channel spectrometer) is
    series-independent, so sharding ``(nseries, ndf, 256)`` over ``chunk``
    needs ZERO collectives and the output channels follow their series
    shard.

    Requires ``n_chunk | nchk`` (shards own whole frequency chunks). Output
    the ``P([None,] None, chunk)`` shard of ``(nout, [4,] nchan *
    max(nfft, 1))``.

    ``streaming`` (``nfft`` > 0 only): ``step(rows, history=None) ->
    (out, new_history)`` — the int16 carry ``(nseries_l, halo, 2)``
    shards over ``chunk`` like the input, so streaming needs ZERO
    collectives.
    """
    _check_rows_factory(nfft, ntap, streaming)
    n_chunk = axis_size(mesh, CHUNK_AXIS)
    out_spec = (None, None, CHUNK_AXIS) if stokes else (None, CHUNK_AXIS)

    def step1(rows, history, return_history):
        nseries_l = rows.shape[0]
        if nseries_l % (NCHAN_CHK * NPOL_SAMP):
            raise ValueError(
                f"series shard {nseries_l} must hold whole frequency "
                f"chunks ({NCHAN_CHK * NPOL_SAMP} series each): use "
                f"n_chunk dividing nchk (mesh chunk={n_chunk})")
        return _rows_detect(rows, history, return_history, nfft, ntap,
                            window, nout, stokes, mean, shift)

    return _spec_step(_streaming(step1, streaming), (CHUNK_AXIS,), out_spec,
                      (CHUNK_AXIS,) if streaming else None)
