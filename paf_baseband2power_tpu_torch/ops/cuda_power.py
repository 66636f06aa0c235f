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
"""

from __future__ import annotations

import collections

import torch

from ..constants import NCHAN_CHK
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


def _launch(family: str, layout: str, x: torch.Tensor, dims: tuple[int, int],
            shape: tuple[int, ...], divisor: int | None) -> torch.Tensor:
    """The window sums of ``x`` and their float32 epilogue."""
    return _finish(family, _accumulate(family, layout, x, dims, shape),
                   divisor)


def detect_sums(x: torch.Tensor, nout: int = 1, stokes: bool = False,
                layout: str = "wire") -> torch.Tensor:
    """Exact int64 window sums of a wire ``(ndf, nchk * 3584)`` or rows
    ``(nseries, ndf, 256)`` block: ``(nout, nchan)`` for power, ``(nout,
    4, nchan)`` of ``|x|^2, |y|^2, Re(x y*), Im(x y*)`` for Stokes. The
    sums of several shards add exactly, and ``finish_sums`` turns the
    total into the records a single device gives, bit for bit.

    On the card this is the detection kernel without its epilogue, counted
    under the wrapper that launches it for the same shape; on the CPU the
    plain version's sums."""
    family = "stokes" if stokes else "power"
    if layout == "wire":
        ndf, nchk = P.wire_geometry(x, nout)
        if _on_cpu(x):
            return (P.stokes_sums_2d if stokes else P.power_sums_2d)(x, nout)
        dims, nchan = (ndf, nchk), nchk * NCHAN_CHK
        name = (f"baseband2{family}_cuda" if nout == 1
                else f"baseband2{family}_scrunch_cuda")
    elif layout == "rows":
        x = P.rows_geometry(x, nout)
        if _on_cpu(x):
            return (P.stokes_sums_rows if stokes else P.power_sums_rows)(
                x, nout)
        dims = _rows_dims(x)
        nchan = dims[0] // 2
        name = f"baseband2{family}_scrunch_rows_cuda"
    else:
        raise ValueError(f"unknown layout '{layout}'")
    shape = (nout, 4, nchan) if stokes else (nout, nchan)
    acc = _accumulate(family, layout, x, dims, shape)
    launches[name] += 1
    return acc


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
    ndf, nchk = P.wire_geometry(block2d, nout)
    if _on_cpu(block2d):
        return P.baseband2power_scrunch_2d(block2d, nout, mean=mean)
    out = _launch("power", "wire", block2d, (ndf, nchk),
                  (nout, nchk * NCHAN_CHK),
                  P.mean_divisor(ndf // nout) if mean else None)
    launches["baseband2power_scrunch_cuda"] += 1
    return out


def baseband2power_cuda(block2d: torch.Tensor,
                        mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nchk * 7,)`` float32
    (port of ``baseband2power_pallas``)."""
    ndf, nchk = P.wire_geometry(block2d, 1)
    if _on_cpu(block2d):
        return P.baseband2power_2d(block2d, mean=mean)
    out = _launch("power", "wire", block2d, (ndf, nchk),
                  (1, nchk * NCHAN_CHK), P.mean_divisor(ndf) if mean else None)
    launches["baseband2power_cuda"] += 1
    return out[0]


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
    x3 = P.rows_geometry(rows, nout)
    if _on_cpu(rows):
        return P.baseband2power_scrunch_rows(rows, nout, mean=mean)
    nseries, ndf = _rows_dims(x3)
    out = _launch("power", "rows", x3, (nseries, ndf), (nout, nseries // 2),
                  P.mean_divisor(ndf // nout) if mean else None)
    launches["baseband2power_scrunch_rows_cuda"] += 1
    return out


def _rows_dims(x3: torch.Tensor) -> tuple[int, int]:
    """``(nseries, ndf)`` of a 3-D rows block the kernels can index."""
    nseries, ndf, lanes = x3.shape
    if lanes != P.ROW_LANES:
        raise ValueError(f"series rows need {P.ROW_LANES} lanes per frame, "
                         f"got {lanes}")
    return nseries, ndf


def baseband2stokes_scrunch_cuda(block2d: torch.Tensor, nout: int,
                                 mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, 4, nchk * 7)``
    float32, rows I, Q, U, V (port of ``baseband2stokes_scrunch_pallas``,
    any ``nout`` dividing ``ndf``)."""
    ndf, nchk = P.wire_geometry(block2d, nout)
    if _on_cpu(block2d):
        return P.baseband2stokes_scrunch_2d(block2d, nout, mean=mean)
    out = _launch("stokes", "wire", block2d, (ndf, nchk),
                  (nout, 4, nchk * NCHAN_CHK),
                  P.stokes_mean_divisor(ndf // nout) if mean else None)
    launches["baseband2stokes_scrunch_cuda"] += 1
    return out


def baseband2stokes_cuda(block2d: torch.Tensor,
                         mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(4, nchk * 7)`` float32,
    rows I, Q, U, V (port of ``baseband2stokes_pallas``)."""
    ndf, nchk = P.wire_geometry(block2d, 1)
    if _on_cpu(block2d):
        return P.baseband2stokes_2d(block2d, mean=mean)
    out = _launch("stokes", "wire", block2d, (ndf, nchk),
                  (1, 4, nchk * NCHAN_CHK),
                  P.stokes_mean_divisor(ndf) if mean else None)
    launches["baseband2stokes_cuda"] += 1
    return out[0]


def baseband2stokes_scrunch_rows_cuda(rows: torch.Tensor, nout: int = 1,
                                      mean: bool = False) -> torch.Tensor:
    """Series rows ``(nseries, ndf, 256)`` (or 2-D ``(nseries, ndf * 256)``)
    int16 -> ``(nout, 4, nseries / 2)`` float32, rows I, Q, U, V (port of
    ``baseband2stokes_scrunch_rows_pallas``, both its tile classes)."""
    x3 = P.rows_geometry(rows, nout)
    if _on_cpu(rows):
        return P.baseband2stokes_scrunch_rows(rows, nout, mean=mean)
    nseries, ndf = _rows_dims(x3)
    out = _launch("stokes", "rows", x3, (nseries, ndf),
                  (nout, 4, nseries // 2),
                  P.stokes_mean_divisor(ndf // nout) if mean else None)
    launches["baseband2stokes_scrunch_rows_cuda"] += 1
    return out
