"""Detection on the card: bindings of ``csrc/power.cu`` and
``csrc/stokes.cu``.

Counterpart of ``paf_baseband2power_tpu/ops/pallas_power.py``'s entry
points for power and full Stokes (wire, wire x ``nout`` windows, series
rows). One CUDA kernel family serves each; see the notes at the top of the
two sources.

Dispatch is by the input's device and nothing else: a CPU tensor goes to
the plain version in ``ops/power.py``, a CUDA tensor to the kernel, which
either launches or raises. No path falls back from one to the other.

``launches`` counts kernel launches by wrapper name; each wrapper adds one
where its kernel is launched, so a run can show it went through the card.

This module is the one home of the direct step: every wrapper is a call of
one body (``_detect``), and ``detect`` gives the executor its record for a
mode (power or Stokes, wire or rows, ``nout``, ``mean``).
"""

from __future__ import annotations

import collections

import torch

from ..constants import NCHAN_CHK, NPOL_SAMP
from . import power as P
from ._build import load_library

launches: collections.Counter = collections.Counter()


def pack_block_2d(block6d):
    """Canonical 6-D block -> wire layout ``(ndf, nchk * 3584)`` (a view)."""
    return block6d.reshape(block6d.shape[0], -1)


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor, which takes the plain version; False for a
    CUDA tensor the kernels take; raises for anything else."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels take cpu or cuda tensors, got "
                         f"{x.device}")
    if x.dtype != torch.int16:
        raise TypeError(f"the kernels take int16 blocks, got {x.dtype}")
    if x.device.type == "cpu":
        return True
    if not x.is_contiguous():
        raise ValueError("the kernels take contiguous blocks")
    return False


def _accumulate(family: str, layout: str, x: torch.Tensor,
                dims: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """Run ``pafb2p_<family>_<layout>`` on ``x`` into an int64 scratch of
    ``shape``: the exact window sums."""
    if layout == "rows" and x.shape[-1] != P.ROW_LANES:
        raise ValueError(f"series rows need {P.ROW_LANES} lanes per frame, "
                         f"got {x.shape[-1]}")
    lib = load_library()
    if x.data_ptr() % 16:
        raise ValueError("the kernels need 16-byte aligned blocks")
    acc = torch.zeros(shape, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        launch = getattr(lib, f"pafb2p_{family}_{layout}")
        _raise(lib, launch(x.data_ptr(), *dims, shape[0], acc.data_ptr(),
                           stream))
    return acc


def _finish(family: str, acc: torch.Tensor,
            divisor: int | None) -> torch.Tensor:
    """The float32 epilogue ``pafb2p_<family>_finish`` of an int64
    scratch."""
    lib = load_library()
    acc = acc.contiguous()
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    with torch.cuda.device(acc.device):
        finish = getattr(lib, f"pafb2p_{family}_finish")
        _raise(lib, finish(acc.data_ptr(), out.data_ptr(), acc.shape[0],
                           acc.shape[-1], float(divisor or 0), stream))
    return out


def _wrapper(stokes: bool, layout: str, nout: int) -> str:
    """The wrapper whose name counts a mode's launches: ``baseband2power``
    or ``baseband2stokes``, then ``_cuda`` (wire, one window),
    ``_scrunch_cuda`` (wire) or ``_scrunch_rows_cuda`` (rows)."""
    family = "stokes" if stokes else "power"
    if layout == "rows":
        return f"baseband2{family}_scrunch_rows_cuda"
    return f"baseband2{family}_{'' if nout == 1 else 'scrunch_'}cuda"


def _sums(block: torch.Tensor, nout: int, stokes: bool, layout: str,
          name: str | None) -> tuple[torch.Tensor, int]:
    """The exact int64 window sums of ``block`` and the frames per window:
    the plain version's for a CPU tensor, else the kernel's, counted under
    ``name`` (by default ``_wrapper``'s)."""
    if layout == "wire":
        ndf, nchk = P.wire_geometry(block, nout)
        x, dims, nchan = block, (ndf, nchk), nchk * NCHAN_CHK
        plain = P.stokes_sums_2d if stokes else P.power_sums_2d
    elif layout == "rows":
        x = P.rows_geometry(block, nout)
        nseries, ndf, _ = x.shape
        dims, nchan = (nseries, ndf), nseries // NPOL_SAMP
        plain = P.stokes_sums_rows if stokes else P.power_sums_rows
    else:
        raise ValueError(f"unknown layout '{layout}'")
    if _on_cpu(block):
        return plain(x, nout), ndf // nout
    acc = _accumulate("stokes" if stokes else "power", layout, x, dims,
                      (nout, 4, nchan) if stokes else (nout, nchan))
    launches[name or _wrapper(stokes, layout, nout)] += 1
    return acc, ndf // nout


def _detect(block: torch.Tensor, nout: int, stokes: bool, layout: str,
            mean: bool, name: str | None = None) -> torch.Tensor:
    """Float32 records ``(nout, nchan)``, or ``(nout, 4, nchan)`` with
    ``stokes``, of a wire or rows block: the body of every wrapper."""
    acc, ndf_w = _sums(block, nout, stokes, layout, name)
    divisor = None
    if mean:
        divisor = (P.stokes_mean_divisor if stokes else P.mean_divisor)(ndf_w)
    return finish_sums(acc, stokes, divisor)


def detect(block: torch.Tensor, nout: int = 1, stokes: bool = False,
           layout: str = "wire", mean: bool = False) -> torch.Tensor:
    """The executor's record of a wire ``(ndf, nchk * 3584)`` or rows
    ``(nseries, ndf, 256)`` block: ``(nout, nchan)`` float32 power or
    ``(nout, 4, nchan)`` Stokes I, Q, U, V, without the ``nout`` axis at
    ``nout = 1``. Counted under ``_wrapper``'s name for the mode."""
    out = _detect(block, nout, stokes, layout, mean)
    return out.select(0, 0) if nout == 1 else out


def detect_sums(x: torch.Tensor, nout: int = 1, stokes: bool = False,
                layout: str = "wire") -> torch.Tensor:
    """Exact int64 window sums of a wire ``(ndf, nchk * 3584)`` or rows
    ``(nseries, ndf, 256)`` block: ``(nout, nchan)`` for power, ``(nout,
    4, nchan)`` of ``|x|^2, |y|^2, Re(x y*), Im(x y*)`` for Stokes. The
    sums of several shards add exactly, and ``finish_sums`` turns the
    total into the records a single device gives, bit for bit.

    On the card this is the detection kernel without its epilogue, counted
    as ``detect`` counts the same mode; on the CPU the plain version's
    sums."""
    return _sums(x, nout, stokes, layout, None)[0]


def finish_sums(acc: torch.Tensor, stokes: bool = False,
                divisor: int | None = None) -> torch.Tensor:
    """``detect_sums``'s int64 sums (or a sum of them) -> float32 records,
    divided in float64 by ``divisor`` for the mean; the kernels' epilogue
    on the card, the plain one on the CPU."""
    if acc.device.type == "cpu":
        return P.finish_sums(acc, stokes, divisor)
    return _finish("stokes" if stokes else "power", acc, divisor)


def _raise(lib, code: int) -> None:
    if code:
        raise RuntimeError(f"CUDA launch failed: "
                           f"{lib.pafb2p_error_string(code).decode()}")


def baseband2power_scrunch_cuda(block2d: torch.Tensor, nout: int,
                                mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, nchk * 7)``
    float32 (port of ``baseband2power_scrunch_pallas``)."""
    return _detect(block2d, nout, False, "wire", mean,
                   "baseband2power_scrunch_cuda")


def baseband2power_cuda(block2d: torch.Tensor,
                        mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nchk * 7,)`` float32
    (port of ``baseband2power_pallas``)."""
    return detect(block2d, 1, False, "wire", mean)


def baseband2power_cuda_bytes(raw_u8: torch.Tensor, ndf: int, nchk: int,
                              mean: bool = False) -> torch.Tensor:
    """Raw block bytes ``(ndf * nchk * 7168,) uint8`` -> ``(nchk * 7,)``
    float32 through a zero-copy int16 view."""
    return baseband2power_cuda(P.bytes_to_block_2d(raw_u8, ndf, nchk),
                               mean=mean)


def baseband2power_scrunch_rows_cuda(rows: torch.Tensor, nout: int = 1,
                                     mean: bool = False) -> torch.Tensor:
    """Series rows ``(nseries, ndf, 256)`` (or 2-D ``(nseries, ndf * 256)``)
    int16 -> ``(nout, nseries / 2)`` float32 (port of
    ``baseband2power_scrunch_rows_pallas``)."""
    return _detect(rows, nout, False, "rows", mean)


def baseband2stokes_scrunch_cuda(block2d: torch.Tensor, nout: int,
                                 mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, 4, nchk * 7)``
    float32, rows I, Q, U, V (port of ``baseband2stokes_scrunch_pallas``,
    any ``nout`` dividing ``ndf``)."""
    return _detect(block2d, nout, True, "wire", mean,
                   "baseband2stokes_scrunch_cuda")


def baseband2stokes_cuda(block2d: torch.Tensor,
                         mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(4, nchk * 7)`` float32,
    rows I, Q, U, V (port of ``baseband2stokes_pallas``)."""
    return detect(block2d, 1, True, "wire", mean)


def baseband2stokes_scrunch_rows_cuda(rows: torch.Tensor, nout: int = 1,
                                      mean: bool = False) -> torch.Tensor:
    """Series rows ``(nseries, ndf, 256)`` (or 2-D ``(nseries, ndf * 256)``)
    int16 -> ``(nout, 4, nseries / 2)`` float32, rows I, Q, U, V (port of
    ``baseband2stokes_scrunch_rows_pallas``, both its tile classes)."""
    return _detect(rows, nout, True, "rows", mean)
