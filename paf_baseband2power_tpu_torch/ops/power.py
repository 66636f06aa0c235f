"""Plain PyTorch power path: unpack int16 baseband -> |x|^2 (or full
Stokes) -> integrate.

Counterparts of ``paf_baseband2power_tpu/ops/power.py`` with the same
signatures, errors, output shapes, chunk-major channel order and ``mean``
divisors (samples x 2 pols per window for power, samples only for Stokes).
They are the reference for the CUDA kernels in ``ops/cuda_power.py``: the
CPU tests run them, and on the card they run only to check the kernels.

Sums are exact: products are accumulated in int64 (a channel sums at most
8192 * 128 * 2 * 2 terms of at most 2^30, below 2^52), converted to
float64, divided there for ``mean``, and rounded once to float32. That is
the arithmetic of ``ops/golden.py`` (``baseband2power_golden``,
``baseband2stokes_golden``), whose float64 partial sums are all integers
below 2^53, so results are bit-identical to the float64 golden model. The
frame axis is walked in slabs to bound the int64 temporaries.
"""

from __future__ import annotations

import torch

from ..constants import (
    DT_SIZE,
    NCHAN_CHK,
    NDIM_POL,
    NPOL_SAMP,
    NSAMP_DF,
)

LANES_PER_CHUNK = DT_SIZE // 2          # 3584 int16 lanes per chunk-frame
ROW_LANES = 2 * NSAMP_DF                # 256 int16 lanes per series-frame
_SLAB_ELEMS = 1 << 25                   # int64 elements per temporary slab


def wire_geometry(block2d: torch.Tensor, nout: int) -> tuple[int, int]:
    """Validate a wire block ``(ndf, nchk * 3584)`` for ``nout`` windows;
    returns ``(ndf, nchk)``."""
    ndf, lanes = block2d.shape
    if nout < 1 or ndf % nout:
        raise ValueError(f"nout={nout} must divide ndf={ndf}")
    if lanes % LANES_PER_CHUNK:
        raise ValueError(
            f"lane dim {lanes} not a multiple of {LANES_PER_CHUNK}")
    return ndf, lanes // LANES_PER_CHUNK


def rows_geometry(rows: torch.Tensor, nout: int) -> torch.Tensor:
    """Validate a series-row block for ``nout`` windows; returns it 3-D
    ``(nseries, ndf, lanes)`` (a 2-D ``(nseries, ndf * 256)`` block is
    viewed with 256 lanes per frame)."""
    if rows.ndim == 3:
        nseries, ndf, lanes = rows.shape
        cols = ndf * lanes
    else:
        nseries, cols = rows.shape
        ndf, lanes = cols // ROW_LANES, ROW_LANES
    if nout < 1 or cols % ROW_LANES or ndf % nout:
        raise ValueError(
            f"nout={nout} must divide the {ndf} frames per block "
            "(windows align to whole frames, matching the wire path)")
    if nseries % NPOL_SAMP:
        raise ValueError(f"{nseries} series do not pair into pols")
    return rows.reshape(nseries, ndf, lanes)


def mean_divisor(ndf_w: int) -> int:
    """Samples x 2 pols integrated into one ``mean`` output of a window of
    ``ndf_w`` frames (both layouts)."""
    return ndf_w * NSAMP_DF * NPOL_SAMP


def _finish(power: torch.Tensor, divisor: int | None) -> torch.Tensor:
    """Exact int64 sums -> float32, dividing in float64 for the mean."""
    p = power.to(torch.float64)
    if divisor:
        p = p / divisor
    return p.to(torch.float32).contiguous()


def _slab(row_elems: int) -> int:
    return max(1, _SLAB_ELEMS // row_elems)


def finish_sums(sums: torch.Tensor, stokes: bool = False,
                divisor: int | None = None) -> torch.Tensor:
    """Exact int64 window sums (``power_sums_*`` or ``stokes_sums_*``, or
    the sum of several blocks' or shards' of them) -> the float32 records,
    dividing in float64 for the mean."""
    return (_finish_stokes if stokes else _finish)(sums, divisor)


def power_sums_2d(block2d: torch.Tensor, nout: int) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> exact int64 sums
    ``(nout, nchk * 7)`` of each of ``nout`` equal frame windows."""
    ndf, nchk = wire_geometry(block2d, nout)
    nchan = nchk * NCHAN_CHK
    per_frame = torch.empty((ndf, nchan), dtype=torch.int64,
                            device=block2d.device)
    step = _slab(block2d.shape[1])
    for f0 in range(0, ndf, step):
        x = block2d[f0:f0 + step].to(torch.int64)
        per_frame[f0:f0 + step] = (
            (x * x).reshape(-1, nchk, NSAMP_DF, NCHAN_CHK,
                            NPOL_SAMP * NDIM_POL)
            .sum(dim=(2, 4)).reshape(-1, nchan))
    return per_frame.reshape(nout, ndf // nout, nchan).sum(dim=1)


def baseband2power_scrunch_2d(block2d: torch.Tensor, nout: int,
                              mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, nchk * 7)``
    float32: each of ``nout`` equal frame windows integrated on its own."""
    sums = power_sums_2d(block2d, nout)
    ndf_w = block2d.shape[0] // nout
    return _finish(sums, mean_divisor(ndf_w) if mean else None)


def baseband2power_2d(block2d: torch.Tensor,
                      mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nchk * 7,)`` float32."""
    return baseband2power_scrunch_2d(block2d, 1, mean=mean)[0]


def baseband2power(block: torch.Tensor, mean: bool = False) -> torch.Tensor:
    """Canonical 6-D block ``(ndf, nchk, 128, 7, 2, 2) int16`` ->
    ``(nchk * 7,)`` float32; channel index = chunk * 7 + chan."""
    ndf, nchk, _nsamp, _nchan, _npol, _ndim = block.shape
    return baseband2power_2d(block.reshape(ndf, -1), mean=mean)


def bytes_to_block_2d(raw: torch.Tensor, ndf: int, nchk: int) -> torch.Tensor:
    """Raw little-endian block bytes ``(nbytes,) uint8`` -> wire block
    ``(ndf, nchk * 3584) int16``, a zero-copy view."""
    if raw.numel() != ndf * nchk * DT_SIZE:
        raise ValueError(
            f"raw block must be {ndf * nchk * DT_SIZE} bytes, "
            f"got {raw.numel()}")
    return raw.view(torch.int16).reshape(ndf, nchk * LANES_PER_CHUNK)


def baseband2power_bytes(raw: torch.Tensor, ndf: int, nchk: int,
                         mean: bool = False) -> torch.Tensor:
    """Power integration straight from raw ring-block bytes (uint8)."""
    return baseband2power_2d(bytes_to_block_2d(raw, ndf, nchk), mean=mean)


def power_sums_rows(rows: torch.Tensor, nout: int = 1) -> torch.Tensor:
    """Series-row block -> exact int64 sums ``(nout, nseries / 2)``, the
    two pol series of a channel summed."""
    x3 = rows_geometry(rows, nout)
    nseries, ndf, lanes = x3.shape
    per_frame = torch.empty((nseries, ndf), dtype=torch.int64,
                            device=rows.device)
    step = _slab(nseries * lanes)
    for f0 in range(0, ndf, step):
        x = x3[:, f0:f0 + step].to(torch.int64)
        per_frame[:, f0:f0 + step] = (x * x).sum(dim=2)
    return (per_frame.reshape(nseries // NPOL_SAMP, NPOL_SAMP, nout,
                              ndf // nout).sum(dim=(1, 3)).T)


def baseband2power_scrunch_rows(rows: torch.Tensor, nout: int = 1,
                                mean: bool = False) -> torch.Tensor:
    """Series-row block, 3-D ``(nseries, ndf, 256)`` or 2-D
    ``(nseries, ndf * 256)`` int16 with ``nseries = nchk * 14`` ->
    ``(nout, nchan)`` float32; the two pol series of a channel are
    summed."""
    sums = power_sums_rows(rows, nout)
    ndf_w = rows_geometry(rows, nout).shape[1] // nout
    return _finish(sums, mean_divisor(ndf_w) if mean else None)


def stokes_mean_divisor(ndf_w: int) -> int:
    """Samples integrated into one Stokes ``mean`` output of a window of
    ``ndf_w`` frames: no pol factor, the Stokes convention."""
    return ndf_w * NSAMP_DF


def _stokes_terms(xr, xi, yr, yi, dim) -> torch.Tensor:
    """int64 ``|x|^2, |y|^2, Re(x y*), Im(x y*)`` summed over ``dim``,
    stacked on a new leading axis."""
    return torch.stack([(xr * xr + xi * xi).sum(dim=dim),
                        (yr * yr + yi * yi).sum(dim=dim),
                        (xr * yr + xi * yi).sum(dim=dim),
                        (xi * yr - xr * yi).sum(dim=dim)])


def _finish_stokes(terms: torch.Tensor, divisor: int | None) -> torch.Tensor:
    """``(nout, 4, nchan)`` int64 ``xx, yy, re, im`` -> I, Q, U, V float32,
    formed exactly in int64 (Q, U and V are signed)."""
    xx, yy, re, im = terms.unbind(dim=1)
    return _finish(torch.stack([xx + yy, xx - yy, 2 * re, 2 * im], dim=1),
                   divisor)


def stokes_sums_2d(block2d: torch.Tensor, nout: int) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> exact int64 sums
    ``(nout, 4, nchk * 7)`` of ``|x|^2, |y|^2, Re(x y*), Im(x y*)`` over
    each of ``nout`` equal frame windows."""
    ndf, nchk = wire_geometry(block2d, nout)
    nchan = nchk * NCHAN_CHK
    per_frame = torch.empty((ndf, 4, nchan), dtype=torch.int64,
                            device=block2d.device)
    step = _slab(block2d.shape[1])
    for f0 in range(0, ndf, step):
        # lanes within a chunk: [sample, chan, pol, dim]
        v = (block2d[f0:f0 + step].to(torch.int64)
             .reshape(-1, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL))
        terms = _stokes_terms(v[..., 0, 0], v[..., 0, 1], v[..., 1, 0],
                              v[..., 1, 1], dim=2)      # (4, f, nchk, 7)
        per_frame[f0:f0 + step] = terms.reshape(4, -1, nchan).transpose(0, 1)
    return per_frame.reshape(nout, ndf // nout, 4, nchan).sum(dim=1)


def baseband2stokes_scrunch_2d(block2d: torch.Tensor, nout: int,
                               mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, 4, nchk * 7)``
    float32, rows I, Q, U, V: each of ``nout`` equal frame windows
    integrated on its own."""
    terms = stokes_sums_2d(block2d, nout)
    ndf_w = block2d.shape[0] // nout
    return _finish_stokes(terms, stokes_mean_divisor(ndf_w) if mean else None)


def baseband2stokes_2d(block2d: torch.Tensor,
                       mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(4, nchk * 7)`` float32,
    rows I, Q, U, V."""
    return baseband2stokes_scrunch_2d(block2d, 1, mean=mean)[0]


def stokes_sums_rows(rows: torch.Tensor, nout: int = 1) -> torch.Tensor:
    """Series-row block -> exact int64 sums ``(nout, 4, nseries / 2)`` of
    ``|x|^2, |y|^2, Re(x y*), Im(x y*)``. Series ``2k`` and ``2k + 1`` are
    channel ``k``'s x and y, with re and im interleaved on lanes."""
    x3 = rows_geometry(rows, nout)
    nseries, ndf, lanes = x3.shape
    nchan = nseries // NPOL_SAMP
    per_frame = torch.empty((4, nchan, ndf), dtype=torch.int64,
                            device=rows.device)
    step = _slab(nseries * lanes)
    for f0 in range(0, ndf, step):
        v = (x3[:, f0:f0 + step].to(torch.int64)
             .reshape(nchan, NPOL_SAMP, -1, lanes // 2, 2))
        per_frame[:, :, f0:f0 + step] = _stokes_terms(
            v[:, 0, ..., 0], v[:, 0, ..., 1], v[:, 1, ..., 0],
            v[:, 1, ..., 1], dim=2)                     # (4, nchan, f)
    terms = per_frame.reshape(4, nchan, nout, ndf // nout).sum(dim=3)
    return terms.permute(2, 0, 1)


def baseband2stokes_scrunch_rows(rows: torch.Tensor, nout: int = 1,
                                 mean: bool = False) -> torch.Tensor:
    """Series-row block, 3-D ``(nseries, ndf, 256)`` or 2-D
    ``(nseries, ndf * 256)`` int16 -> ``(nout, 4, nseries / 2)`` float32,
    rows I, Q, U, V."""
    terms = stokes_sums_rows(rows, nout)
    ndf_w = rows_geometry(rows, nout).shape[1] // nout
    return _finish_stokes(terms, stokes_mean_divisor(ndf_w) if mean else None)


def power_step(block: torch.Tensor) -> torch.Tensor:
    """One block's sum-mode power, wire 2-D or canonical 6-D."""
    if block.ndim == 2:
        return baseband2power_2d(block)
    return baseband2power(block)
