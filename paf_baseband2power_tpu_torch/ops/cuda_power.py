"""Direct power on the card: bindings of ``csrc/power.cu``.

Counterpart of ``paf_baseband2power_tpu/ops/pallas_power.py``'s power
entry points (wire, wire x ``nout`` windows, series rows). One CUDA kernel
family serves all of them; see the note at the top of ``csrc/power.cu``.

Dispatch is by the input's device and nothing else: a CPU tensor goes to
the plain version in ``ops/power.py``, a CUDA tensor to the kernel, which
either launches or raises. No path falls back from one to the other.

``launches`` counts kernel launches by wrapper name; each wrapper adds one
where its kernel is launched, so a run can show it went through the card.
"""

from __future__ import annotations

import collections

import torch

from paf_baseband2power_tpu.constants import NCHAN_CHK
from . import power as P
from ._build import load_library

launches: collections.Counter = collections.Counter()


def pack_block_2d(block6d):
    """Canonical 6-D block -> wire layout ``(ndf, nchk * 3584)`` (a view)."""
    return block6d.reshape(block6d.shape[0], -1)


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"power kernels take cpu or cuda tensors, got "
                         f"{x.device}")
    if x.dtype != torch.int16:
        raise TypeError(f"power kernels take int16 blocks, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("power kernels take contiguous blocks")


def _launch(kernel: str, x: torch.Tensor, dims: tuple[int, int],
            nchan: int, nout: int, divisor: int | None) -> torch.Tensor:
    """Run ``pafb2p_power_<kernel>`` on ``x`` and its float32 epilogue."""
    lib = load_library()
    if x.data_ptr() % 16:
        raise ValueError("power kernels need 16-byte aligned blocks")
    acc = torch.zeros((nout, nchan), dtype=torch.int64, device=x.device)
    out = torch.empty((nout, nchan), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        launch = getattr(lib, f"pafb2p_power_{kernel}")
        _raise(lib, launch(x.data_ptr(), *dims, nout, acc.data_ptr(),
                           stream))
        _raise(lib, lib.pafb2p_power_finish(
            acc.data_ptr(), out.data_ptr(), acc.numel(),
            float(divisor or 0), stream))
    return out


def _raise(lib, code: int) -> None:
    if code:
        raise RuntimeError(f"CUDA launch failed: "
                           f"{lib.pafb2p_error_string(code).decode()}")


def baseband2power_scrunch_cuda(block2d: torch.Tensor, nout: int,
                                mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nout, nchk * 7)``
    float32 (port of ``baseband2power_scrunch_pallas``)."""
    ndf, nchk = P.wire_geometry(block2d, nout)
    if block2d.device.type == "cpu":
        return P.baseband2power_scrunch_2d(block2d, nout, mean=mean)
    _check_cuda(block2d)
    out = _launch("wire", block2d, (ndf, nchk), nchk * NCHAN_CHK, nout,
                  P.mean_divisor(ndf // nout) if mean else None)
    launches["baseband2power_scrunch_cuda"] += 1
    return out


def baseband2power_cuda(block2d: torch.Tensor,
                        mean: bool = False) -> torch.Tensor:
    """Wire block ``(ndf, nchk * 3584) int16`` -> ``(nchk * 7,)`` float32
    (port of ``baseband2power_pallas``)."""
    ndf, nchk = P.wire_geometry(block2d, 1)
    if block2d.device.type == "cpu":
        return P.baseband2power_2d(block2d, mean=mean)
    _check_cuda(block2d)
    out = _launch("wire", block2d, (ndf, nchk), nchk * NCHAN_CHK, 1,
                  P.mean_divisor(ndf) if mean else None)
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
    if rows.device.type == "cpu":
        return P.baseband2power_scrunch_rows(rows, nout, mean=mean)
    _check_cuda(rows)
    nseries, ndf, lanes = x3.shape
    if lanes != P.ROW_LANES:
        raise ValueError(f"series rows need {P.ROW_LANES} lanes per frame, "
                         f"got {lanes}")
    out = _launch("rows", x3, (nseries, ndf), nseries // 2, nout,
                  P.mean_divisor(ndf // nout) if mean else None)
    launches["baseband2power_scrunch_rows_cuda"] += 1
    return out
